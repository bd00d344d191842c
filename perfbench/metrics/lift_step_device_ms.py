"""lift_step_device_ms: device time of what was launched under the
harness's range around each lift step (the stacking, the upload, the step
and its copy back), a step."""


def read(ctx):
    steps = ctx["probe"].traced.get("steps")
    if not steps:
        return None
    return 1e3 * ctx["trace"].device_s_under(["lift_step"]) / steps
