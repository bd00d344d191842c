"""medoid_roofline: the medoid sums' bound (every unordered pair of a
mask's kept points at the f32 peak, or the rows read at the HBM peak, the
larger; flops.medoid_bound_s) over the device time of what
cm3d_torch::medoid_sums launched."""

from perfbench import flops
from perfbench.metrics import _lift


def read(ctx):
    steps = _lift.steps(ctx)
    seconds = ctx["trace"].device_s_under(["cm3d_torch::medoid_sums"])
    if not steps or not seconds:
        return None
    bound = sum(flops.medoid_bound_s(z, w["kept_mask"].ravel()) for z, w in steps)
    return 100.0 * bound / seconds
