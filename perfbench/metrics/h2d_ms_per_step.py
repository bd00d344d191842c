"""h2d_ms_per_step: device time of the host-to-device copies in the traced
part with the host's ranges, a lift step."""


def read(ctx):
    steps = ctx["probe"].traced.get("steps")
    if not steps:
        return None
    return 1e3 * ctx["trace"].copies_s("HtoD") / steps
