"""compact_roofline: the three compactions' bound (flops.step_compact_bound_s,
with the selected sources these inputs have) over the device time of what
cm3d_torch::compact_rows launched."""

from perfbench import flops
from perfbench.metrics import _lift


def read(ctx):
    steps = _lift.steps(ctx)
    seconds = ctx["trace"].device_s_under(["cm3d_torch::compact_rows"])
    if not steps or not seconds:
        return None
    nc, nu, k = steps[0][0]["nc"], steps[0][0]["nu"], steps[0][0]["k"]
    bound = sum(flops.step_compact_bound_s(
        z, int(w["in_image"].clip(max=nc).sum()), int(w["in_union"].clip(max=nu).sum()),
        int(w["in_mask"].clip(max=k).sum())) for z, w in steps)
    return 100.0 * bound / seconds
