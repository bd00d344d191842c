"""The port's sorted-segment reductions, pillarize and the permutation
gather against the JAX package on the CPU.

The JAX side runs as its own tests run it: the Pallas kernels in interpret
mode, `voxelize._USE_PALLAS_SEGMENT` set to "interpret" and to False (the
scatter formulation). The port's wrappers run their plain versions here (CPU
tensors); the CUDA kernels are held to the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: sums differ from the JAX paths only by f32 addition order, rtol
1e-5 / atol 1e-5 as tests/test_segment_pallas.py; maxima, empty cells, the
sink and the gather VJP are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3d_tpu.kernels.segment_pallas import segment_sum_max_pallas, segment_sum_pallas
from cm3d_tpu.train import bevfusion as jbev
from cm3d_tpu.train import voxelize as jvox
from cm3d_tpu.train.centerpoint import CenterPointConfig as JCenterPointConfig
from cm3d_tpu_torch.kernels.segment import (
    segment_sum,
    segment_sum_bwd,
    segment_sum_bwd_plain,
    segment_sum_max,
    segment_sum_max_plain,
    segment_sum_plain,
)
from cm3d_tpu_torch.train import bevfusion as tbev
from cm3d_tpu_torch.train import voxelize as tvox
from cm3d_tpu_torch.train.centerpoint import CenterPointConfig

SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, r, n, d, n_cells, sink_frac=0.2):
    """Sorted ids with empty cells, a sink tail, zeroed / -inf ignored rows."""
    rng = np.random.default_rng(seed)
    used = rng.permutation(n_cells)[: max(1, 2 * n_cells // 3)]  # the rest stay empty
    cell = rng.choice(used, (r, n)).astype(np.int32)
    sink = rng.random((r, n)) < sink_frac
    cell[sink] = n_cells + rng.integers(0, 3, int(sink.sum()))
    cell.sort(axis=1)
    values = rng.normal(size=(r, d, n)).astype(np.float32)
    maxvals = rng.normal(size=(r, n)).astype(np.float32)
    ignored = cell >= n_cells
    values[np.broadcast_to(ignored[:, None, :], values.shape)] = 0.0
    maxvals[ignored] = -np.inf
    return cell, values, maxvals


SHAPES = [(1, 64, 1, 7), (2, 300, 5, 33), (3, 1000, 4, 129), (2, 257, 8, 600)]


@pytest.mark.parametrize("r,n,d,n_cells", SHAPES)
def test_segment_sum_max_matches_pallas(r, n, d, n_cells):
    cell, values, maxvals = _inputs(r + n, r, n, d, n_cells)
    want_s, want_m = segment_sum_max_pallas(
        jnp.asarray(cell), jnp.asarray(values), jnp.asarray(maxvals), n_cells, interpret=True)
    got_s, got_m = segment_sum_max(torch.from_numpy(cell), torch.from_numpy(values),
                                   torch.from_numpy(maxvals), n_cells)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SUM_TOL)
    # maxima and the -inf of empty cells are exact
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    empty = np.ones((r, n_cells), bool)
    for row in range(r):
        empty[row, cell[row][cell[row] < n_cells]] = False
    assert empty.any(), "the fixture has empty cells"
    assert np.all(got_m.numpy()[empty] == -np.inf)
    assert np.all(got_s.numpy()[np.broadcast_to(empty[:, None], got_s.shape)] == 0.0)


@pytest.mark.parametrize("r,n,d,n_cells", SHAPES)
def test_segment_sum_and_vjp_match_pallas(r, n, d, n_cells):
    cell, values, _ = _inputs(7 * r + n, r, n, d, n_cells)
    ct = np.random.default_rng(1).normal(size=(r, d, n_cells)).astype(np.float32)

    def loss(v):
        return jnp.sum(segment_sum_pallas(jnp.asarray(cell), v, n_cells, True) * ct)

    want = segment_sum_pallas(jnp.asarray(cell), jnp.asarray(values), n_cells, True)
    want_grad = jax.grad(loss)(jnp.asarray(values))
    v = torch.from_numpy(values).requires_grad_()
    got = segment_sum(torch.from_numpy(cell), v, n_cells)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUM_TOL)
    # the VJP is a gather of the cotangent: exact, sink ids read 0
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(want_grad))
    assert np.all(v.grad.numpy()[np.broadcast_to((cell >= n_cells)[:, None], values.shape)] == 0)


def test_segment_backward_is_the_gather_of_autograd():
    """The Function's gather backward equals autograd through the plain
    scatter version, bit for bit, and the plain versions take any order."""
    cell, values, maxvals = _inputs(5, 2, 400, 6, 50)
    c = torch.from_numpy(cell)
    ct = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6, 50)).astype(np.float32))
    a = torch.from_numpy(values).requires_grad_()
    b = torch.from_numpy(values).requires_grad_()
    (segment_sum(c, a, 50) * ct).sum().backward()
    (segment_sum_plain(c, b, 50) * ct).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(segment_sum_bwd(c, ct), segment_sum_bwd_plain(c, ct))
    assert torch.equal(segment_sum_bwd(c, ct), a.grad)

    perm = torch.from_numpy(np.random.default_rng(3).permutation(400))
    s0, m0 = segment_sum_max_plain(c, torch.from_numpy(values), torch.from_numpy(maxvals), 50)
    s1, m1 = segment_sum_max_plain(c[:, perm], torch.from_numpy(values)[:, :, perm],
                                   torch.from_numpy(maxvals)[:, perm], 50)
    torch.testing.assert_close(s1, s0, **SUM_TOL)
    assert torch.equal(m1, m0)


def test_segment_wrappers_reject_bad_inputs():
    cell = torch.zeros((2, 8), dtype=torch.int32)
    values = torch.zeros((2, 3, 8))
    with pytest.raises(TypeError, match="int32"):
        segment_sum(cell.long(), values, 4)
    with pytest.raises(TypeError, match="float32"):
        segment_sum(cell, values.double(), 4)
    with pytest.raises(ValueError, match="expected"):
        segment_sum(cell, values[:, :, :7], 4)
    with pytest.raises(ValueError, match="maxvals"):
        segment_sum_max(cell, values, torch.zeros((2, 7)), 4)
    with pytest.raises(ValueError, match="n_cells"):
        segment_sum(cell, values, 0)


def test_apply_permutation_matches_jax():
    rng = np.random.default_rng(3)
    n, f = 37, 5
    vals = rng.normal(size=(2, n, f)).astype(np.float32)
    perm = np.stack([rng.permutation(n), rng.permutation(n)]).astype(np.int32)
    ct = rng.normal(size=(2, n, f)).astype(np.float32)

    def loss(v, p):
        inv = jnp.argsort(p).astype(jnp.int32)
        return jnp.sum(jvox.apply_permutation(v, p, inv) * ct[0])

    tp = torch.from_numpy(perm).long()
    inv = tvox.inverse_permutation(tp)
    np.testing.assert_array_equal(inv.numpy(), np.argsort(perm, axis=1))
    v = torch.from_numpy(vals).requires_grad_()
    out = tvox.apply_permutation(v, tp, inv)
    np.testing.assert_array_equal(out.detach().numpy()[0], vals[0][perm[0]])
    (out * torch.from_numpy(np.stack([ct[0], ct[0]]))).sum().backward()
    for b in range(2):
        want = jax.grad(loss)(jnp.asarray(vals[b]), jnp.asarray(perm[b]))
        np.testing.assert_array_equal(v.grad.numpy()[b], np.asarray(want))


def _cloud(seed, b, n, cfg):
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(cfg.x_min - 3, cfg.x_max + 3, (b, n))
    pts[..., 1] = rng.uniform(cfg.y_min - 3, cfg.y_max + 3, (b, n))
    pts[..., 2] = rng.uniform(cfg.z_min - 1, cfg.z_max + 1, (b, n))
    pts[..., 3] = rng.random((b, n))
    # points exactly on cell edges: the binning division must agree
    pts[:, :64, 0] = cfg.x_min + cfg.resolution * rng.integers(0, 20, (b, 64))
    pts[:, 64:128, 1] = cfg.y_min + cfg.resolution * rng.integers(0, 20, (b, 64))
    valid = rng.random((b, n)) < 0.9
    return pts, valid


@pytest.mark.parametrize("mode", [False, "interpret"])
def test_pillarize_matches_jax(monkeypatch, mode):
    monkeypatch.setattr(jvox, "_USE_PALLAS_SEGMENT", mode)
    jcfg = jvox.PillarConfig(x_min=-12.8, x_max=12.8, y_min=-12.8, y_max=12.8, resolution=0.8)
    tcfg = tvox.PillarConfig(x_min=-12.8, x_max=12.8, y_min=-12.8, y_max=12.8, resolution=0.8)
    assert jcfg.grid_hw == tcfg.grid_hw
    pts, valid = _cloud(11, 2, 4096, jcfg)
    want = jax.vmap(lambda p, v: jvox.pillarize(p, v, jcfg))(jnp.asarray(pts), jnp.asarray(valid))
    got = tvox.pillarize(torch.from_numpy(pts), torch.from_numpy(valid), tcfg)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 32, 32, 6)
    # counts (log1p) and max z are exact up to the log; means by addition order
    np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)
    np.testing.assert_array_equal(got.numpy()[..., 4], want[..., 4])
    single = tvox.pillarize(torch.from_numpy(pts[0]), torch.from_numpy(valid[0]), tcfg)
    assert torch.equal(single, got[0])


def test_pillar_config_defaults_match():
    j, t = jvox.PillarConfig(), tvox.PillarConfig()
    assert j.grid_hw == t.grid_hw == (128, 128)
    assert j.num_features == t.num_features == 6


def _spy(monkeypatch, module, name, seen):
    """Record (cell, n_cells) of each call of module.name, then run it."""
    real = getattr(module, name)

    def spy(cell, *args):
        seen.append((cell.clone(), args[-1]))
        return real(cell, *args)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("mode", [False, "interpret"])
def test_pillarize_passes_the_grid_as_n_cells(monkeypatch, mode):
    """pillarize hands the kernel n_cells = h*w: its out-of-grid and invalid
    points carry the id h*w, a sink past every column, and are never
    summed; the features still equal the JAX package's."""
    monkeypatch.setattr(jvox, "_USE_PALLAS_SEGMENT", mode)
    seen = []
    _spy(monkeypatch, tvox, "segment_sum_max", seen)
    geo = dict(x_min=-6.4, x_max=6.4, y_min=-4.0, y_max=4.0, resolution=0.8)
    jcfg, tcfg = jvox.PillarConfig(**geo), tvox.PillarConfig(**geo)
    h, w = tcfg.grid_hw
    pts, valid = _cloud(4, 2, 3000, jcfg)
    got = tvox.pillarize(torch.from_numpy(pts), torch.from_numpy(valid), tcfg)
    want = jax.vmap(lambda p, v: jvox.pillarize(p, v, jcfg))(jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)
    ((cell, n_cells),) = seen
    assert n_cells == h * w
    sink = cell >= n_cells
    assert bool(sink.any()) and bool((cell[sink] == h * w).all())
    assert bool((cell[~sink] >= 0).all())
    assert bool((cell[:, 1:] >= cell[:, :-1]).all())


@pytest.mark.parametrize("mode", [False, "interpret"])
def test_splat_to_bev_passes_the_grid_as_n_cells(monkeypatch, mode):
    """splat_to_bev hands the kernel n_cells = h*w, rays that leave the grid
    at the id h*w; the pooled map and its gradient still equal the JAX
    package's, and the backward gives the sink's elements 0."""
    monkeypatch.setattr(jvox, "_USE_PALLAS_SEGMENT", mode)
    seen = []
    _spy(monkeypatch, tbev, "segment_sum", seen)
    geo = dict(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, resolution=1.0, z_min=-3.0,
               z_max=3.0)
    kw = dict(cam_channels=4, depth_bins=4, d_min=1.0, d_max=7.0, cam_trunk=(4, 8))
    jcfg = jbev.BevFusionConfig(centerpoint=JCenterPointConfig(num_classes=3), **kw)
    tcfg = tbev.BevFusionConfig(centerpoint=CenterPointConfig(num_classes=3), **kw)
    jpill, tpill = jvox.PillarConfig(**geo), tvox.PillarConfig(**geo)
    h, w = tpill.grid_hw
    rng = np.random.default_rng(8)
    b, c, hf, wf = 2, 2, 6, 8
    feats = rng.normal(size=(b, c, hf, wf, 4)).astype(np.float32)
    dp = rng.random((b, c, hf, wf, 4)).astype(np.float32)
    dp /= dp.sum(-1, keepdims=True)
    ih, iw = hf * tcfg.img_stride, wf * tcfg.img_stride
    intr = np.tile(np.array([[12.0, 0, iw / 2], [0, 12.0, ih / 2], [0, 0, 1]], np.float32),
                   (b, c, 1, 1))
    e0 = [[0, 0, 1, 0.5], [-1, 0, 0, 0.0], [0, -1, 0, 0.2], [0, 0, 0, 1]]  # along +x ego
    e1 = [[-1, 0, 0, 0.0], [0, 0, -1, -0.5], [0, -1, 0, 0.2], [0, 0, 0, 1]]  # along -y ego
    ext = np.tile(np.array([e0, e1], np.float32), (b, 1, 1, 1))
    ct = rng.normal(size=(b, h, w, 4)).astype(np.float32)

    def jloss(f):
        out = jax.vmap(lambda f_, d_, k_, e_: jbev.splat_to_bev(f_, d_, k_, e_, jpill, jcfg))(
            f, jnp.asarray(dp), jnp.asarray(intr), jnp.asarray(ext))
        return jnp.sum(out * ct), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    got = tbev.splat_to_bev(tf, torch.from_numpy(dp), torch.from_numpy(intr),
                            torch.from_numpy(ext), tpill, tcfg)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUM_TOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    ((cell, n_cells),) = seen
    assert n_cells == h * w
    sink = cell >= n_cells
    assert bool(sink.any()) and bool((~sink).any()) and bool((cell[sink] == h * w).all())
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(b, 4, n_cells)).astype(np.float32))
    assert bool((segment_sum_bwd(cell, g).transpose(1, 2)[sink] == 0).all())
