"""The port's training modules against the JAX package on the CPU:
CenterPointDetector (train and eval mode, with the updated batch statistics),
build_targets, both losses, first-step gradients and three optimizer steps,
decode_detections with ties, and the augmentation's geometry.

Both sides get the same numpy inputs and the same parameters: the flax tree
of a JAX init, converted by `models/convert.py`. Tolerances are stated where
they are used; they cover f32 addition order in the convolutions and segment
sums, flax's one-pass batch variance against the two-pass one here, and
Adam's division by a small second moment, which amplifies them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3d_tpu.train import augment as jaug
from cm3d_tpu.train import targets as jtargets
from cm3d_tpu.train import train as jtrain
from cm3d_tpu.train.centerpoint import CenterPointConfig as JCenterPointConfig
from cm3d_tpu.train.centerpoint import CenterPointDetector as JCenterPointDetector
from cm3d_tpu.train.voxelize import PillarConfig as JPillarConfig
from cm3d_tpu.train.voxelize import pillarize as jpillarize
from cm3d_tpu_torch.models.convert import centerpoint_state_dict_from_flax
from cm3d_tpu_torch.train import augment as taug
from cm3d_tpu_torch.train import targets as ttargets
from cm3d_tpu_torch.train import train as ttrain
from cm3d_tpu_torch.train.centerpoint import CenterPointConfig, CenterPointDetector
from cm3d_tpu_torch.train.voxelize import PillarConfig, pillarize

GEO = dict(x_min=-25.6, x_max=25.6, y_min=-25.6, y_max=25.6, resolution=0.8)
JPILLAR, PILLAR = JPillarConfig(**GEO), PillarConfig(**GEO)
MODEL_KW = dict(num_classes=3, trunk_channels=(32, 32))
JMODEL, MODEL = JCenterPointConfig(**MODEL_KW), CenterPointConfig(**MODEL_KW)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _make_batch(seed=53, b=2, n=4096, m=6):
    """The fixture of tests/test_train.py, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n, 4), np.float32)
    valid = np.zeros((b, n), bool)
    boxes = np.zeros((b, m, 8), np.float32)
    bvalid = np.zeros((b, m), bool)
    for i in range(b):
        bg = rng.uniform([-25, -25, -2], [25, 25, 0], (n - m * 200, 3))
        allp = [np.concatenate([bg, rng.random((len(bg), 1))], axis=1)]
        for j in range(m):
            cx, cy = rng.uniform(-20, 20, 2)
            boxes[i, j] = [cx, cy, 0.8, 2.0, 4.5, 1.6, rng.uniform(-np.pi, np.pi),
                           int(rng.integers(0, 3))]
            bvalid[i, j] = True
            allp.append(np.concatenate(
                [rng.normal([cx, cy, 0.8], [4.5 / 4, 2.0 / 4, 1.6 / 4], (200, 3)),
                 rng.random((200, 1))], axis=1))
        p = np.concatenate(allp)[:n]
        pts[i, : len(p)] = p
        valid[i, : len(p)] = True
    return pts, valid, boxes, bvalid


def _jax_model(seed=0):
    model = JCenterPointDetector(JMODEL)
    h, w = JPILLAR.grid_hw
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 6)), train=True)
    return model, variables


def _port_model(variables):
    model = CenterPointDetector(MODEL)
    v = _np_tree(variables)
    model.load_state_dict(centerpoint_state_dict_from_flax(v["params"], v["batch_stats"], MODEL))
    return model


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


def test_centerpoint_forward_and_batch_stats_match(jax_model):
    jmodel, variables = jax_model
    pts, valid, _, _ = _make_batch()
    pillars = pillarize(torch.from_numpy(pts), torch.from_numpy(valid), PILLAR)
    jp = jnp.asarray(pillars.numpy())
    model = _port_model(variables)
    assert set(model.state_dict()) == set(centerpoint_state_dict_from_flax(
        *(_np_tree(variables)[k] for k in ("params", "batch_stats")), MODEL))
    # init: the heatmap bias is the CenterNet -4.6 in both
    assert float(model.heatmap_out.bias.detach()[0]) == pytest.approx(-4.6)

    want_eval = jmodel.apply(variables, jp, train=False)
    model.eval()
    with torch.no_grad():
        got_eval = model(pillars)
    want_train, mutated = jmodel.apply(variables, jp, train=True, mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        got_train = model(pillars)
    for name in ("heatmap", "offset", "z", "size", "yaw"):
        # f32 convolutions in another addition order, three blocks deep
        np.testing.assert_allclose(got_eval[name].numpy(), np.asarray(want_eval[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"eval {name}")
        np.testing.assert_allclose(got_train[name].numpy(), np.asarray(want_train[name]),
                                   rtol=1e-4, atol=2e-5, err_msg=f"train {name}")
    # the running statistics after one training forward: flax folds the
    # BIASED batch variance in with momentum 0.99
    stats = centerpoint_state_dict_from_flax(
        _np_tree(variables)["params"], _np_tree(mutated)["batch_stats"], MODEL)
    moved = 0
    for key, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        moved += int(not np.allclose(buf.numpy(), 0.0) and not np.allclose(buf.numpy(), 1.0))
    assert moved > 0, "the batch statistics moved"
    # torch.nn.BatchNorm2d's unbiased update would differ by n / (n - 1)
    # already in the first step: n = 2 * 32 * 32 here, 5e-4 relative
    var0 = model.trunk0_a.bn.running_var.numpy()
    batch_var = (var0 - 0.99) / 0.01
    n = 2 * 32 * 32
    assert np.abs(0.99 + 0.01 * batch_var * n / (n - 1) - var0).max() > 1e-7


def _targets_boxes():
    res = PILLAR.resolution * 2
    h = PILLAR.grid_hw[0] // 2
    edge_x = PILLAR.x_min + (h - 1 + 0.5) * res
    boxes = np.zeros((2, 6, 8), np.float32)
    boxes[0, 0] = [5.0, -3.0, 0.5, 2.0, 4.5, 1.6, 0.3, 1]
    boxes[0, 1] = [5.3, -3.2, 0.7, 1.0, 2.0, 1.5, -1.0, 2]  # same cell as box 0
    boxes[0, 2] = [5.1, -2.9, 0.9, 0.6, 0.7, 1.7, 2.0, 0]   # and a third
    boxes[0, 3] = [edge_x, 0.0, 0.5, 2.0, 4.5, 1.6, 0.3, 1]  # the last cell
    boxes[0, 4] = [edge_x + 5.0, 0.0, 0.5, 2.0, 4.5, 1.6, 0.3, 2]  # off the grid
    boxes[0, 5] = [-9.0, 12.0, 0.2, 1.9, 4.0, 1.5, 0.1, 0]  # invalid
    boxes[1] = np.random.default_rng(0).uniform(-20, 20, (6, 8))
    boxes[1, :, 3:6] = np.abs(boxes[1, :, 3:6]) * 0.2 + 0.5
    boxes[1, :, 7] = [0, 1, 2, 0, 1, 2]
    valid = np.ones((2, 6), bool)
    valid[0, 5] = False
    return boxes, valid


def test_build_targets_matches_jax_with_collision_and_off_grid_box():
    boxes, valid = _targets_boxes()
    got = ttargets.build_targets(torch.from_numpy(boxes), torch.from_numpy(valid), PILLAR, 3, 2)
    for b in range(2):
        want = jtargets.build_targets(jnp.asarray(boxes[b]), jnp.asarray(valid[b]), JPILLAR, 3, 2)
        # the gaussians: exp of the same f32 expression
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
        # the collision's winner is the highest box index, as XLA's CPU
        # scatter applies the writes in order; every value is exact but for
        # log / sin / cos in two libraries
        np.testing.assert_allclose(got[1][b].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(want[2]))
    res = PILLAR.resolution * 2
    ix, iy = int((5.0 - PILLAR.x_min) / res), int((-3.0 - PILLAR.y_min) / res)
    assert got[1][0][ix, iy, 2] == pytest.approx(0.9)  # box 2 won the cell
    assert int(got[2][0].sum()) == 2  # the collision cell and the edge cell
    assert float(got[0][0][..., 2].max()) == 1.0  # box 1 still splats its class
    single = ttargets.build_targets(torch.from_numpy(boxes[0]), torch.from_numpy(valid[0]),
                                    PILLAR, 3, 2)
    assert all(torch.equal(s, g[0]) for s, g in zip(single, got))


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(-2, 2, (2, 16, 16, 3)).astype(np.float32)
    gt = rng.random((2, 16, 16, 3)).astype(np.float32) ** 4
    gt[0, 3, 4, 1] = gt[1, 9, 2, 0] = 1.0
    pred = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    reg = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    mask = rng.random((2, 16, 16)) < 0.05
    # f32 sums over a few thousand terms in two orders
    np.testing.assert_allclose(
        float(ttargets.focal_loss(torch.from_numpy(logits), torch.from_numpy(gt))),
        float(jtargets.focal_loss(jnp.asarray(logits), jnp.asarray(gt))), rtol=1e-5)
    np.testing.assert_allclose(
        float(ttargets.reg_loss(torch.from_numpy(pred), torch.from_numpy(reg),
                                torch.from_numpy(mask))),
        float(jtargets.reg_loss(jnp.asarray(pred), jnp.asarray(reg), jnp.asarray(mask))),
        rtol=1e-5)
    none = np.zeros_like(mask)
    assert float(ttargets.reg_loss(torch.from_numpy(pred), torch.from_numpy(reg),
                                   torch.from_numpy(none))) == 0.0
    l, w = rng.uniform(0.3, 6, 50).astype(np.float32), rng.uniform(0.3, 6, 50).astype(np.float32)
    np.testing.assert_allclose(
        ttargets.gaussian_radius(torch.from_numpy(l), torch.from_numpy(w)).numpy(),
        np.asarray(jtargets.gaussian_radius(jnp.asarray(l), jnp.asarray(w))), rtol=1e-6)


def _jax_loss(jmodel, params, batch_stats, batch):
    pts, valid, boxes, bvalid = (jnp.asarray(a) for a in batch)
    pillars = jax.vmap(lambda p, v: jpillarize(p, v, JPILLAR))(pts, valid)
    out, _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, pillars, train=True,
                          mutable=["batch_stats"])
    hm_t, reg_t, reg_m = jax.vmap(
        lambda b, v: jtargets.build_targets(b, v, JPILLAR, 3, 2))(boxes, bvalid)
    pred = jnp.concatenate([out["offset"], out["z"], out["size"], out["yaw"]], axis=-1)
    return jtargets.focal_loss(out["heatmap"], hm_t) + 2.0 * jtargets.reg_loss(pred, reg_t, reg_m)


def _torch_batch(batch):
    return ttrain.TrainBatch(*(torch.from_numpy(a) for a in batch))


def test_first_step_gradients_match_jax(jax_model):
    jmodel, variables = jax_model
    batch = _make_batch()
    want_loss, want = jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, variables["batch_stats"], batch))(variables["params"])
    want = centerpoint_state_dict_from_flax(
        _np_tree(want), _np_tree(variables)["batch_stats"], MODEL)
    model = _port_model(variables).train()
    tb = _torch_batch(batch)
    out = model(pillarize(tb.points, tb.point_valid, PILLAR))
    hm_t, reg_t, reg_m = ttargets.build_targets(tb.boxes, tb.box_valid, PILLAR, 3, 2)
    pred = torch.cat([out["offset"], out["z"], out["size"], out["yaw"]], dim=-1)
    loss = ttargets.focal_loss(out["heatmap"], hm_t) + 2.0 * ttargets.reg_loss(pred, reg_t, reg_m)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        # relative to the tensor's largest gradient: sums over 2 x 32 x 32
        # positions in another order, behind batch-norm's division
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max() + 1e-7, name


@pytest.mark.parametrize("recipe", ["adamw", "clip_cosine_ema"])
def test_three_train_steps_match_jax(jax_model, recipe):
    """Loss of three steps, the parameters' and batch statistics' state after
    them (and the EMA), against the JAX train step from the same parameters.
    Adam divides by sqrt(v) + 1e-8, so a gradient difference of 1e-7 where
    the gradient itself is that small moves an update by a fraction of lr:
    parameters are held to a few lr (3e-3), losses to 2e-3 relative."""
    jmodel, variables = jax_model
    batch = _make_batch()
    lr = 3e-3
    if recipe == "adamw":
        jtx, ttx, kw = None, None, {}
    else:
        okw = dict(total_steps=4, schedule="cosine", warmup_steps=1, grad_clip=1.0)
        jtx, ttx = jtrain.make_optimizer(lr, **okw), ttrain.make_optimizer(lr, **okw)
        kw = dict(ema_decay=0.5)
    ema = bool(kw)
    import optax

    jtx = jtx if jtx is not None else optax.adamw(lr)
    jstate = jtrain.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtx.init(variables["params"]), step=jnp.zeros((), jnp.int32),
        ema_params=variables["params"] if ema else None)
    jstep = jax.jit(jtrain.make_train_step(jmodel, jtx, JPILLAR, **kw))
    jbatch = jtrain.TrainBatch(*(jnp.asarray(a) for a in batch))

    model = _port_model(variables)
    ttx = ttx if ttx is not None else ttrain.make_optimizer(lr)
    state = ttrain.state_for(model, ttx, ema)
    step = ttrain.make_train_step(model, ttx, PILLAR, **kw)
    tb = _torch_batch(batch)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, tm = step(state, tb)
        for key in ("loss", "loss_heatmap", "loss_reg"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-3,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == 3 and state.opt_state["count"] == 3
    want = centerpoint_state_dict_from_flax(
        _np_tree(jstate.params), _np_tree(jstate.batch_stats), MODEL)
    for name, p in model.state_dict().items():
        tol = 1e-5 if name.endswith(("running_mean", "running_var")) else 3 * lr
        assert np.abs(p.numpy() - want[name].numpy()).max() <= tol, name
    if ema:
        want_ema = centerpoint_state_dict_from_flax(
            _np_tree(jstate.ema_params), _np_tree(jstate.batch_stats), MODEL)
        for name, e in state.ema_params.items():
            assert np.abs(e.numpy() - want_ema[name].numpy()).max() <= 3 * lr, name
            assert not torch.equal(e, state.params[name])  # the EMA lags


def test_optimizer_is_optax_adamw_on_given_gradients():
    """The update rule alone, on the same gradients: AdamW with decay 1e-4
    on every parameter, the clip c / max(norm, c), the warm-up + cosine
    schedule read at the update count. f32 rounding only: 1e-6."""
    rng = np.random.default_rng(9)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (10.0, 0.01, 1.0, 3.0, 0.5)]
    okw = dict(total_steps=5, schedule="cosine", warmup_steps=2, grad_clip=1.0)
    jtx = jtrain.make_optimizer(1e-2, **okw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jp)
    ttx = ttrain.make_optimizer(1e-2, **okw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttx.init(tp)
    import optax

    for g in grads:
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, topt, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    assert not np.allclose(tp["a"].numpy(), params["a"])
    const = ttrain.make_optimizer(1e-2, schedule="const", warmup_steps=4)
    assert [const.lr(i) for i in (0, 2, 4, 9)] == pytest.approx([0.0, 5e-3, 1e-2, 1e-2])
    with pytest.raises(ValueError, match="total_steps"):
        ttrain.make_optimizer(1e-3, schedule="cosine")
    with pytest.raises(ValueError, match="unknown schedule"):
        ttrain.make_optimizer(1e-3, schedule="step")


def test_decode_detections_with_ties_matches_jax():
    """At init every heatmap logit is the same bias: top-k and the class
    argmax must break ties as jax.lax.top_k and jnp.argmax do (lower index
    first)."""
    rng = np.random.default_rng(6)
    h = w = 16
    out = {"heatmap": np.full((h, w, 3), -4.6, np.float32),
           "offset": rng.normal(size=(h, w, 2)).astype(np.float32),
           "z": rng.normal(size=(h, w, 1)).astype(np.float32),
           "size": rng.normal(size=(h, w, 3)).astype(np.float32),
           "yaw": rng.normal(size=(h, w, 2)).astype(np.float32)}
    out["heatmap"][3, 5, 1] = out["heatmap"][9, 2, 2] = out["heatmap"][9, 2, 0] = 1.5
    out["heatmap"][12, 12, 2] = 0.2
    for top_k in (8, 40):
        want = jtrain.decode_detections({k: jnp.asarray(v) for k, v in out.items()},
                                        JPILLAR, 2, top_k=top_k)
        got = ttrain.decode_detections({k: torch.from_numpy(v) for k, v in out.items()},
                                       PILLAR, 2, top_k=top_k)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    batched = ttrain.decode_detections(
        {k: torch.from_numpy(np.stack([v, v])) for k, v in out.items()}, PILLAR, 2, top_k=8)
    single = ttrain.decode_detections({k: torch.from_numpy(v) for k, v in out.items()},
                                      PILLAR, 2, top_k=8)
    assert all(torch.equal(b[1], s) for b, s in zip(batched, single))


def test_augment_geometry_matches_jax_for_shared_affine_parameters():
    """The two packages draw from different generators; given the same
    flips, angle, scale and shift (taken from the JAX draw) the transformed
    points, boxes and cam_to_ego agree to f32 rounding (1e-5 m at 30 m)."""
    cfg = jaug.AugmentConfig(rot_max=0.6, scale_min=0.9, scale_max=1.1, translate_std=0.3)
    rng = np.random.default_rng(53)
    b, n, m, c = 4, 16, 5, 2
    pts = rng.normal(0, 10, (b, n, 4)).astype(np.float32)
    boxes = np.zeros((b, m, 8), np.float32)
    boxes[..., :3] = rng.normal(0, 10, (b, m, 3))
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, (b, m, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    boxes[..., 7] = rng.integers(0, 3, (b, m))
    cams = np.tile(np.eye(4, dtype=np.float32), (b, c, 1, 1))
    cams[..., :3, 3] = rng.normal(0, 2, (b, c, 3))
    key = jax.random.PRNGKey(11)
    want = jaug.augment_batch(key, jnp.asarray(pts), jnp.asarray(boxes), cfg,
                              cam_to_ego=jnp.asarray(cams))
    keys = jax.random.split(key, b)
    drawn = [jaug._sample_affine(k, cfg) for k in keys]
    a = np.stack([np.asarray(d[0]) for d in drawn])
    params = taug.AffineParams(
        flip_x=torch.tensor([bool(d[1][0]) for d in drawn]),
        flip_y=torch.tensor([bool(d[1][1]) for d in drawn]),
        theta=torch.tensor([float(d[2]) for d in drawn]),
        scale=torch.tensor([float(d[3]) for d in drawn]),
        shift=torch.from_numpy(a[:, :3, 3].copy()))
    assert len({(bool(d[1][0]), bool(d[1][1])) for d in drawn}) > 1, "flips vary"
    np.testing.assert_allclose(taug.affine_matrix(params).numpy(), a, rtol=1e-6, atol=1e-6)
    got = taug.apply_affine(params, torch.from_numpy(pts), torch.from_numpy(boxes),
                            torch.from_numpy(cams))
    for g, w_, name in zip(got, want, ("points", "boxes", "cam_to_ego")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    # the port's own draws: in range, and replayed by (seed, step)
    tcfg = taug.AugmentConfig()
    p1 = taug.sample_affine(taug.step_generator(3, 7), 64, tcfg)
    p2 = taug.sample_affine(taug.step_generator(3, 7), 64, tcfg)
    p3 = taug.sample_affine(taug.step_generator(3, 8), 64, tcfg)
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))
    assert not torch.equal(p1.theta, p3.theta)
    assert float(p1.theta.abs().max()) <= tcfg.rot_max
    assert tcfg.scale_min <= float(p1.scale.min()) and float(p1.scale.max()) <= tcfg.scale_max
    assert 0 < int(p1.flip_x.sum()) < 64 and 0 < int(p1.flip_y.sum()) < 64
    g1 = taug.augment_batch(taug.step_generator(3, 7), torch.from_numpy(pts),
                            torch.from_numpy(boxes), tcfg)
    assert g1[2] is None and torch.equal(g1[0][..., 3], torch.from_numpy(pts[..., 3]))


def _assert_axis_step_of_one_is_the_plain_step(tmp_path):
    import torch.distributed as dist

    batch = _torch_batch(_make_batch(b=2, n=512, m=2))
    runs = []
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        for axis_name in (None, "data"):
            state, model, tx = ttrain.init_state(0, PILLAR, MODEL, device="cpu")
            step = ttrain.make_train_step(model, tx, PILLAR, axis_name=axis_name)
            for _ in range(2):
                state, metrics = step(state, batch)
            runs.append((state, metrics))
    finally:
        dist.destroy_process_group()
    (a, ma), (b, mb) = runs
    for key in ("params", "batch_stats"):
        for name, t in getattr(a, key).items():
            assert torch.equal(t, getattr(b, key)[name]), name
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_train_step_state_validation(tmp_path):
    with pytest.raises(ValueError, match="out_stride"):
        CenterPointConfig(out_stride=4)
    model = CenterPointDetector(MODEL)
    tx = ttrain.make_optimizer(1e-3)
    batch = _torch_batch(_make_batch(b=1, n=512, m=2))
    with pytest.raises(ValueError, match="ema_decay > 0 requires"):
        ttrain.make_train_step(model, tx, PILLAR, ema_decay=0.9)(
            ttrain.state_for(model, tx, False), batch)
    with pytest.raises(ValueError, match="ema_params but ema_decay"):
        ttrain.make_train_step(model, tx, PILLAR)(ttrain.state_for(model, tx, True), batch)
    # the axis_name step (A14a) averages over torch.distributed's default
    # group: without one it refuses; over a group of one it is the plain step
    with pytest.raises(RuntimeError, match="init_process_group"):
        ttrain.make_train_step(model, tx, PILLAR, axis_name="data")
    _assert_axis_step_of_one_is_the_plain_step(tmp_path)
    state, model, tx = ttrain.init_state(0, PILLAR, MODEL, device="cpu")
    assert float(model.heatmap_out.bias.detach()[0]) == pytest.approx(-4.6)
    state, metrics = ttrain.make_train_step(model, tx, PILLAR, augment=taug.AugmentConfig(),
                                            aug_seed=3)(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
