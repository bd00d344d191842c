"""The port's BEVFusion modules against the JAX package on the CPU: the
lift-splat pooling (forward and gradients, against both JAX formulations and
a plain loop), BevFusionDetector with the conv and a tiny Swin camera in
train and eval mode from converted parameters (with the updated batch
statistics), first-step gradients and three steps of the fusion train step,
the camera knobs (remat, bf16, fused), and window attention under autograd.

Both sides get the same numpy inputs and the same parameters (the flax tree
of a JAX init, converted by `models/convert.py`). The JAX side runs its
segment kernel as its own tests do: `_USE_PALLAS_SEGMENT = "interpret"` or
`False`, restored by monkeypatch. Tolerances are stated where they are used.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3d_tpu.models.swin import SwinConfig as JSwinConfig
from cm3d_tpu.train import bevfusion as jbev
from cm3d_tpu.train import voxelize as jvox
from cm3d_tpu.train.centerpoint import CenterPointConfig as JCenterPointConfig
from cm3d_tpu.train.voxelize import PillarConfig as JPillarConfig
from cm3d_tpu_torch.kernels.window_attn import window_attn, window_attn_plain
from cm3d_tpu_torch.kernels.window_attn_relpos import (
    refuse_graph_on_card,
    window_attn_relpos,
    window_attn_relpos_plain,
)
from cm3d_tpu_torch.models.convert import bevfusion_state_dict_from_flax
from cm3d_tpu_torch.models.swin import SwinConfig
from cm3d_tpu_torch.train import bevfusion as tbev
from cm3d_tpu_torch.train import train as ttrain
from cm3d_tpu_torch.train.centerpoint import CenterPointConfig
from cm3d_tpu_torch.train.voxelize import PillarConfig, pillarize

GEO = dict(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, resolution=1.0, z_min=-3.0, z_max=3.0)
JPILLAR, PILLAR = JPillarConfig(**GEO), PillarConfig(**GEO)
CP_KW = dict(num_classes=3, trunk_channels=(8, 8))
CAM_KW = dict(cam_channels=4, depth_bins=4, d_min=1.0, d_max=7.0)
SWIN_KW = dict(embed_dim=8, depths=(1, 1, 1), num_heads=(1, 2, 2), out_indices=(1, 2))
JCONV = jbev.BevFusionConfig(centerpoint=JCenterPointConfig(**CP_KW), cam_trunk=(4, 8), **CAM_KW)
CONV = tbev.BevFusionConfig(centerpoint=CenterPointConfig(**CP_KW), cam_trunk=(4, 8), **CAM_KW)
JSWIN = jbev.BevFusionConfig(centerpoint=JCenterPointConfig(**CP_KW), camera_backbone="swin_t",
                             swin=JSwinConfig(fused_attn=False, **SWIN_KW), **CAM_KW)
SWIN = tbev.BevFusionConfig(centerpoint=CenterPointConfig(**CP_KW), camera_backbone="swin_t",
                            swin=SwinConfig(**SWIN_KW), **CAM_KW)
CASES = {"conv": (JCONV, CONV, (24, 32)), "swin": (JSWIN, SWIN, (48, 64))}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cameras(c=2):
    """Camera 0 looks along +x ego, camera 1 along -y ego."""
    e0 = np.array([[0, 0, 1, 0.5], [-1, 0, 0, 0.0], [0, -1, 0, 0.2], [0, 0, 0, 1]], np.float32)
    e1 = np.array([[-1, 0, 0, 0.0], [0, 0, -1, -0.5], [0, -1, 0, 0.2], [0, 0, 0, 1]], np.float32)
    return np.stack([e0, e1])[:c]


def _splat_inputs(seed=0, b=2, c=2, hf=6, wf=8, cfg=CONV):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, c, hf, wf, cfg.cam_channels)).astype(np.float32)
    dp = rng.random((b, c, hf, wf, cfg.depth_bins)).astype(np.float32)
    dp /= dp.sum(-1, keepdims=True)
    ih, iw = hf * cfg.img_stride, wf * cfg.img_stride
    intr = np.tile(np.array([[12.0, 0, iw / 2], [0, 12.0, ih / 2], [0, 0, 1]], np.float32),
                   (b, c, 1, 1))
    ext = np.tile(_cameras(c), (b, 1, 1, 1))
    ext[1, :, :3, 3] += 0.3  # the second sample's cameras sit elsewhere
    return feats, dp, intr, ext


def _splat_loop(feats, dp, intr, ext, pcfg, cfg):
    """Plain-python lift-splat of one sample: a loop over every (camera,
    pixel, depth bin), summed in f64."""
    c, hf, wf, f = feats.shape
    h, w = pcfg.grid_hw
    d = cfg.bin_depths().numpy()
    bev = np.zeros((h, w, f), np.float64)
    for ci in range(c):
        k, e = intr[ci], ext[ci]
        for vi in range(hf):
            for ui in range(wf):
                u, v = (ui + 0.5) * cfg.img_stride, (vi + 0.5) * cfg.img_stride
                for bi in range(cfg.depth_bins):
                    ray = np.array([(u - k[0, 2]) / k[0, 0] * d[bi],
                                    (v - k[1, 2]) / k[1, 1] * d[bi], d[bi]])
                    p = e[:3, :3] @ ray + e[:3, 3]
                    ix = int(np.floor((p[0] - pcfg.x_min) / pcfg.resolution))
                    iy = int(np.floor((p[1] - pcfg.y_min) / pcfg.resolution))
                    if 0 <= ix < h and 0 <= iy < w and pcfg.z_min < p[2] < pcfg.z_max:
                        bev[ix, iy] += feats[ci, vi, ui] * dp[ci, vi, ui, bi]
    return bev.astype(np.float32)


def _jax_splat(feats, dp, intr, ext):
    return jax.vmap(lambda f, d, k, e: jbev.splat_to_bev(f, d, k, e, JPILLAR, JCONV))(
        feats, dp, intr, ext)


@pytest.mark.parametrize("mode", [False, "interpret"])
def test_splat_to_bev_forward_and_gradients_match_jax(monkeypatch, mode):
    """The pooled map and its gradients in the features and the depth
    distribution. f32 sums of at most a few dozen terms in another order:
    1e-5; the gradients are gathers times the other factor: 1e-6."""
    monkeypatch.setattr(jvox, "_USE_PALLAS_SEGMENT", mode)
    feats, dp, intr, ext = _splat_inputs(seed=2)
    ct = np.random.default_rng(5).normal(size=(2,) + PILLAR.grid_hw + (4,)).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (feats, dp, intr, ext))
    want = _jax_splat(*jargs)
    want_gf, want_gd = jax.grad(
        lambda f, d: jnp.sum(_jax_splat(f, d, jargs[2], jargs[3]) * ct), argnums=(0, 1))(
        jargs[0], jargs[1])

    tf, td = torch.from_numpy(feats).requires_grad_(), torch.from_numpy(dp).requires_grad_()
    got = tbev.splat_to_bev(tf, td, torch.from_numpy(intr), torch.from_numpy(ext), PILLAR, CONV)
    (got * torch.from_numpy(ct)).sum().backward()
    assert float(got.detach().abs().sum()) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_gf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_gd), rtol=1e-5, atol=1e-6)


def test_splat_to_bev_matches_a_plain_loop_and_takes_one_sample():
    feats, dp, intr, ext = _splat_inputs(seed=0)
    args = tuple(torch.from_numpy(a) for a in (feats, dp, intr, ext))
    got = tbev.splat_to_bev(*args, PILLAR, CONV)
    for b in range(2):
        ref = _splat_loop(feats[b], dp[b], intr[b], ext[b], PILLAR, CONV)
        assert np.abs(ref).sum() > 0, "the loop splatted nothing: bad fixture"
        # f32 sums against the f64 loop
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=1e-5, atol=1e-5)
    single = tbev.splat_to_bev(*(a[1] for a in args), PILLAR, CONV)
    assert torch.equal(single, got[1])
    # the sink swallows what leaves the grid: cameras far outside see nothing
    far = args[3].clone()
    far[..., :3, 3] += 100.0
    assert float(tbev.splat_to_bev(args[0], args[1], args[2], far, PILLAR, CONV).abs().sum()) == 0


def _batch(image_hw, seed=0, bsz=2, c=2, n=256, m=3):
    rng = np.random.default_rng(seed)
    ih, iw = image_hw
    boxes = np.zeros((bsz, m, 8), np.float32)
    boxes[..., :3] = rng.uniform(-6, 6, (bsz, m, 3))
    boxes[..., 2] = 0.5
    boxes[..., 3:6] = [1.8, 4.2, 1.6]
    boxes[..., 7] = rng.integers(0, 3, (bsz, m))
    intr = np.array([[12.0, 0, iw / 2], [0, 12.0, ih / 2], [0, 0, 1]], np.float32)
    return dict(
        points=rng.uniform(-7, 7, (bsz, n, 4)).astype(np.float32),
        point_valid=rng.random((bsz, n)) < 0.95,
        boxes=boxes, box_valid=np.ones((bsz, m), bool),
        images=rng.random((bsz, c, ih, iw, 3)).astype(np.float32),
        intrinsics=np.tile(intr, (bsz, c, 1, 1)),
        cam_to_ego=np.tile(_cameras(c), (bsz, 1, 1, 1)))


def _jax_state(jcfg, image_hw, tx=None, ema=False, seed=0):
    return jbev.init_fusion_state(jax.random.PRNGKey(seed), JPILLAR, jcfg, image_hw, n_cams=2,
                                  learning_rate=3e-3, tx=tx, ema=ema)


def _port_model(jstate, cfg):
    model = tbev.BevFusionDetector(cfg, PILLAR)
    sd = bevfusion_state_dict_from_flax(_np_tree(jstate.params), _np_tree(jstate.batch_stats), cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jcfg, cfg, hw = CASES[request.param]
    jstate, jmodel, _ = _jax_state(jcfg, hw)
    return request.param, jcfg, cfg, hw, jstate, jmodel


def test_fusion_detector_train_and_eval_mode_match_jax(case):
    """Head maps in both modes and the batch statistics after one training
    forward. Convolutions (and the tiny Swin) in another f32 addition order,
    behind batch-norm's division: 2e-4 relative, 2e-5 absolute."""
    name, jcfg, cfg, hw, jstate, jmodel = case
    batch = _batch(hw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pillars = pillarize(tb["points"], tb["point_valid"], PILLAR)
    camera = (tb["images"], tb["intrinsics"], tb["cam_to_ego"])
    jvars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    jargs = (jnp.asarray(pillars.numpy()),) + tuple(jnp.asarray(batch[k]) for k in (
        "images", "intrinsics", "cam_to_ego"))
    model = _port_model(jstate, cfg)

    want_eval = jmodel.apply(jvars, *jargs, train=False)
    want_train, mutated = jmodel.apply(jvars, *jargs, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = model.eval()(pillars, *camera)
        got_train = model.train()(pillars, *camera)
    h, w = PILLAR.grid_hw
    assert tuple(got_eval["heatmap"].shape) == (2, h // 2, w // 2, 3)
    for head in ("heatmap", "offset", "z", "size", "yaw"):
        np.testing.assert_allclose(got_eval[head].numpy(), np.asarray(want_eval[head]),
                                   rtol=2e-4, atol=2e-5, err_msg=f"{name} eval {head}")
        np.testing.assert_allclose(got_train[head].numpy(), np.asarray(want_train[head]),
                                   rtol=2e-4, atol=2e-5, err_msg=f"{name} train {head}")
    stats = bevfusion_state_dict_from_flax(
        _np_tree(jstate.params), _np_tree(mutated)["batch_stats"], cfg)
    buffers = dict(model.named_buffers())
    assert any(k.startswith("camera.") for k in buffers) == (name == "conv")
    for key, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), stats[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert not np.allclose(buffers["centerpoint.trunk0_a.bn.running_mean"].numpy(), 0.0)


def _fusion_batches(batch):
    jb = jbev.FusionBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    tb = tbev.FusionBatch(**{k: torch.from_numpy(v) for k, v in batch.items()})
    return jb, tb


def test_fusion_first_step_gradients_match_jax(case, monkeypatch):
    """The loss and every parameter's gradient of the first step, the JAX
    side through its segment kernel in interpret mode. Relative to each
    tensor's largest gradient: 5e-4 (f32 sums in another order behind
    batch-norm's division and the depth softmax)."""
    monkeypatch.setattr(jvox, "_USE_PALLAS_SEGMENT", "interpret")
    name, jcfg, cfg, hw, jstate, jmodel = case
    jb, tb = _fusion_batches(_batch(hw, seed=1))

    def jloss(params):
        from cm3d_tpu.train.targets import build_targets, focal_loss, reg_loss

        pillars = jax.vmap(lambda p, v: jvox.pillarize(p, v, JPILLAR))(jb.points, jb.point_valid)
        out, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats}, pillars,
                              jb.images, jb.intrinsics, jb.cam_to_ego, train=True,
                              mutable=["batch_stats"])
        hm_t, reg_t, reg_m = jax.vmap(lambda b, v: build_targets(b, v, JPILLAR, 3, 2))(
            jb.boxes, jb.box_valid)
        pred = jnp.concatenate([out["offset"], out["z"], out["size"], out["yaw"]], axis=-1)
        return focal_loss(out["heatmap"], hm_t) + 2.0 * reg_loss(pred, reg_t, reg_m)

    want_loss, want = jax.value_and_grad(jloss)(jstate.params)
    want = bevfusion_state_dict_from_flax(_np_tree(want), _np_tree(jstate.batch_stats), cfg)
    model = _port_model(jstate, cfg)
    tx = ttrain.make_optimizer(3e-3)
    step = tbev.make_fusion_train_step(model, tx, PILLAR)
    model.train()
    loss, _ = step.loss_fn(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key, p in model.named_parameters():
        g, w = p.grad.numpy(), want[key].numpy()
        assert np.abs(w).max() > 0, f"{name}: {key} has a gradient in JAX"
        assert np.abs(g - w).max() <= 5e-4 * np.abs(w).max() + 1e-7, key


def test_three_fusion_train_steps_match_jax(case):
    """Three steps of the fusion train step (AdamW, lr 3e-3) from the same
    parameters: losses within 2e-3 relative, batch statistics within 1e-5,
    parameters within a few lr (Adam divides by the root of a small second
    moment, which amplifies a rounding difference to a fraction of lr)."""
    name, jcfg, cfg, hw, jstate, jmodel = case
    lr = 3e-3
    import optax

    jtx = optax.adamw(lr)
    jstate = jstate._replace(opt_state=jtx.init(jstate.params))
    jstep = jax.jit(jbev.make_fusion_train_step(jmodel, jtx, JPILLAR))
    model = _port_model(jstate, cfg)
    tx = ttrain.make_optimizer(lr)
    state = ttrain.state_for(model, tx, False)
    step = tbev.make_fusion_train_step(model, tx, PILLAR)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    jb, tb = _fusion_batches(_batch(hw, seed=2))
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        state, tm = step(state, tb)
        for key in ("loss", "loss_heatmap", "loss_reg"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-3,
                                       err_msg=f"{name} step {i} {key}")
    assert state.step == int(jstate.step) == 3
    want = bevfusion_state_dict_from_flax(
        _np_tree(jstate.params), _np_tree(jstate.batch_stats), cfg)
    for key, p in model.state_dict().items():
        tol = 1e-5 if key.endswith(("running_mean", "running_var")) else 3 * lr
        assert np.abs(p.numpy() - want[key].numpy()).max() <= tol, key
    # the camera branch takes part: its parameters moved
    moved = [k for k, p in model.named_parameters()
             if k.startswith("camera.") and not torch.equal(p, before[k])]
    assert moved, "no camera parameter moved"
    if name == "swin":
        assert any("swin.layers" in k for k in moved)


def test_fusion_config_derivations_match_jax():
    for jcfg, cfg, _ in CASES.values():
        assert cfg.img_stride == jcfg.img_stride
        np.testing.assert_allclose(cfg.bin_depths().numpy(), np.asarray(jcfg.bin_depths()),
                                   rtol=1e-6)
    assert SWIN.img_stride == 8  # patch 4 x 2^min(out_indices)
    full, jfull = tbev.BevFusionConfig(), jbev.BevFusionConfig()
    for field in ("cam_channels", "cam_trunk", "depth_bins", "d_min", "d_max",
                  "camera_backbone", "camera_bf16", "camera_remat", "camera_fused"):
        assert getattr(full, field) == getattr(jfull, field), field
    for field in ("embed_dim", "depths", "num_heads", "out_indices", "window_size", "patch_size"):
        assert getattr(tbev.SWIN_T_CAMERA, field) == getattr(jbev.SWIN_T_CAMERA, field), field
    eff = dataclasses.replace(full, camera_bf16=True, camera_remat=True,
                              camera_fused=False).effective_swin()
    assert (eff.dtype, eff.remat, eff.fused_attn) == ("bfloat16", True, False)
    assert full.effective_swin().fused_attn is True


def test_detector_rejects_unaligned_images_and_unknown_backbone():
    model = tbev.BevFusionDetector(CONV, PILLAR)
    with pytest.raises(AssertionError, match="divisible"):
        model(torch.zeros((1,) + PILLAR.grid_hw + (PILLAR.num_features,)),
              torch.zeros((1, 2, 50, 64, 3)), torch.eye(3).tile(1, 2, 1, 1),
              torch.eye(4).tile(1, 2, 1, 1))
    with pytest.raises(ValueError, match="camera_backbone"):
        tbev.CameraTrunk(tbev.BevFusionConfig(camera_backbone="resnet"))
    # the axis_name step (A14a) needs torch.distributed's default group
    with pytest.raises(RuntimeError, match="init_process_group"):
        tbev.make_fusion_train_step(model, ttrain.make_optimizer(1e-3), PILLAR, axis_name="data")


def _trunk_grads(cfg, images, state_dict=None):
    trunk = tbev.CameraTrunk(cfg)
    if state_dict is not None:
        trunk.load_state_dict(state_dict)
    f, d = trunk(images)
    ((f ** 2).sum() + (d ** 2).sum()).backward()
    return trunk, f, d


def test_camera_remat_and_fused_keep_the_tree_and_the_gradients():
    """camera_remat recomputes blocks on the backward, camera_fused=False
    takes the plain attention branch: the same state dict, the same outputs
    and (f32 on the CPU, where the fused wrapper's backward IS the plain
    branch) the same gradients, to 1e-5 of each tensor's largest: the
    recomputed graphs accumulate in another order."""
    from cm3d_tpu_torch.models.common import init_weights

    images = torch.from_numpy(np.random.default_rng(0).random((2, 48, 64, 3), np.float32))
    base = init_weights(tbev.CameraTrunk(SWIN), torch.Generator().manual_seed(1))
    sd = base.state_dict()
    ref, f0, d0 = _trunk_grads(SWIN, images, sd)
    for knob in (dict(camera_remat=True), dict(camera_fused=False)):
        cfg = dataclasses.replace(SWIN, **knob)
        other, f1, d1 = _trunk_grads(cfg, images, sd)
        assert set(other.state_dict()) == set(sd)
        np.testing.assert_allclose(f1.detach().numpy(), f0.detach().numpy(), rtol=1e-6, atol=1e-6)
        for (k, p), (_, q) in zip(ref.named_parameters(), other.named_parameters()):
            assert p.grad is not None and q.grad is not None, k
            worst = float((q.grad - p.grad).abs().max())
            assert worst <= 1e-5 * float(p.grad.abs().max()) + 1e-7, f"{knob} {k}: {worst}"
    dead = [k for k, p in ref.named_parameters() if float(p.grad.abs().sum()) == 0]
    assert not dead, dead


def test_camera_bf16_keeps_f32_params_and_outputs():
    images = torch.from_numpy(np.random.default_rng(1).random((2, 48, 64, 3), np.float32))
    for cfg in (tbev.BevFusionConfig(cam_channels=4, depth_bins=4, camera_bf16=True),
                dataclasses.replace(SWIN, camera_bf16=True)):
        trunk = tbev.CameraTrunk(cfg).train()
        assert all(p.dtype == torch.float32 for p in trunk.parameters())
        f, d = trunk(images)
        assert f.dtype == torch.float32 and d.dtype == torch.float32
        assert bool(torch.isfinite(f).all())
        np.testing.assert_allclose(d.sum(-1).detach().numpy(), 1.0, rtol=2e-3)


def _window_attn_args(seed, b, h, w, c, heads, win, requires_grad=True):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    args = [rnd(b, h, w, c), 1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
            rnd(3 * c, c, scale=c ** -0.5), rnd(3 * c, scale=0.1), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1), rnd((2 * win - 1) ** 2, heads, scale=0.5)]
    return [t.requires_grad_(requires_grad) for t in args]


@pytest.mark.parametrize("b,h,w,c,heads,win,shift,dtype", [
    (2, 12, 16, 16, 2, 7, 0, torch.float32),
    (2, 12, 16, 16, 2, 7, 3, torch.float32),
    (1, 9, 16, 32, 4, 7, 3, torch.bfloat16),
    (3, 5, 8, 32, 4, 5, 0, torch.float32),  # a window shrunk to the map
])
def test_window_attn_under_autograd_equals_the_plain_branch(b, h, w, c, heads, win, shift, dtype):
    """`window_attn` with inputs that require grad goes through its
    autograd.Function, whose backward recomputes the plain branch: x and all
    seven parameters get the plain branch's gradients, exactly."""
    kw = dict(heads=heads, window=win, shift=shift, dtype=dtype)
    got_in = _window_attn_args(7, b, h, w, c, heads, win)
    ref_in = _window_attn_args(7, b, h, w, c, heads, win)
    out = window_attn(*got_in, **kw)
    ref = window_attn_plain(*ref_in, **kw)
    assert out.grad_fn is not None and "WindowAttn" in type(out.grad_fn).__name__
    assert torch.equal(out, ref)
    ct = torch.from_numpy(np.random.default_rng(8).normal(size=tuple(out.shape))
                          .astype(np.float32)).to(out.dtype)
    out.backward(ct)
    ref.backward(ct)
    for name, g, r in zip(("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "table"),
                          got_in, ref_in):
        assert g.grad is not None and float(g.grad.abs().sum()) > 0, name
        assert torch.equal(g.grad, r.grad), name
    # only the inputs that ask for a gradient get one
    some = _window_attn_args(7, b, h, w, c, heads, win, requires_grad=False)
    some[3].requires_grad_()
    window_attn(*some, **kw).backward(ct)
    assert torch.equal(some[3].grad, ref_in[3].grad)
    assert all(t.grad is None for i, t in enumerate(some) if i != 3)
    # without grad the call records no graph
    with torch.no_grad():
        assert not window_attn(*got_in, **kw).requires_grad


def test_window_attn_relpos_guard():
    """SAM's rel-pos kernels record no graph and SAM is never trained, so on
    the card a call that would need one raises; on the CPU the plain version
    differentiates as before."""
    c, heads, win = 16, 2, 4
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, c)).astype(np.float32)).requires_grad_()
    params = [torch.ones(c), torch.zeros(c),
              torch.from_numpy(rng.normal(size=(3 * c, c)).astype(np.float32) * 0.1),
              torch.zeros(3 * c),
              torch.from_numpy(rng.normal(size=(c, c)).astype(np.float32) * 0.1), torch.zeros(c),
              torch.from_numpy(rng.normal(size=(2 * win - 1, c // heads)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(2 * win - 1, c // heads)).astype(np.float32))]
    kw = dict(heads=heads, window=win, dtype=torch.float32)
    out = window_attn_relpos(x, *params, **kw)
    assert torch.equal(out, window_attn_relpos_plain(x, *params, **kw))
    out.sum().backward()
    assert float(x.grad.abs().sum()) > 0
    on_card = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))
    with pytest.raises(NotImplementedError, match="no backward on the card"):
        refuse_graph_on_card(on_card, *params[:2], params[2].clone().requires_grad_())
    refuse_graph_on_card(on_card, *params)  # nothing requires grad: fine
    with torch.no_grad():
        refuse_graph_on_card(on_card, params[2].clone().requires_grad_())
    refuse_graph_on_card(x, *params)  # a CPU tensor never raises
