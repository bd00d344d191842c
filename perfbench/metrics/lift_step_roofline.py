"""lift_step_roofline: the whole step's bound (inputs read once and
outputs written once at the HBM peak, or the medoid's pair operations at the
f32 peak, the larger; flops.step_bound_s) over the device time under the
step's range."""

from perfbench import flops
from perfbench.metrics import _lift


def read(ctx):
    steps = _lift.steps(ctx)
    seconds = ctx["trace"].device_s_under(["lift_step"])
    if not steps or not seconds:
        return None
    bound = sum(flops.step_bound_s(z, w["kept_mask"].ravel()) for z, w in steps)
    return 100.0 * bound / seconds
