"""The port's SE(3) / point-cloud helpers, `medoid_index` and
`PipelineConfig` against the JAX package's on the same seeded numpy inputs,
with leading batch dimensions, in f32 on the CPU.

Tolerances: the port writes every K = 3 / 4 product out elementwise in a
fixed order, JAX runs an einsum at Precision.HIGHEST, and the norms reduce
in another order; so values agree within a few f32 ulps: atol 1e-6 at unit
scale, 1e-4 m at global-frame coordinates up to 1e3 m (an f32 ulp is
6.1e-5 m there). Booleans and medoid indices are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import cm3d_tpu.config as jax_config
import cm3d_tpu.geometry as jg
from cm3d_tpu.ops.medoid import medoid_index as jax_medoid_index

import cm3d_tpu_torch.config as port_config
import cm3d_tpu_torch.geometry as tg
from cm3d_tpu_torch.ops.medoid import medoid_index

UNIT = 1e-6  # atol at unit scale
METRIC = 1e-4  # atol at coordinates up to 1e3 m
BATCH = (2, 3)  # leading batch dimensions


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _rotmats(rng, shape):
    q = _quats(rng, shape)
    return R.from_quat(np.roll(q.reshape(-1, 4), -1, axis=-1)).as_matrix().reshape(
        shape + (3, 3)).astype(np.float32)


def _translations(rng, shape, scale=300.0):
    return rng.uniform(-scale, scale, shape + (3,)).astype(np.float32)


def _points(rng, shape, n=64, d=5, scale=300.0):
    """xyz uniform in [-scale, scale], so transformed points stay within
    1e3 m; the other columns ride along."""
    p = rng.normal(size=shape + (n, d)).astype(np.float32)
    p[..., :3] = rng.uniform(-scale, scale, shape + (n, 3))
    return p


def _se3(rng, shape):
    return np.array(jg.transform_matrix(jnp.asarray(_translations(rng, shape)),
                                        jnp.asarray(_quats(rng, shape))))


def _pivot_cases():
    """Rotation matrices at the pivot ties and sign flips of the branch-free
    rotmat_to_quat: the identity, 180 degrees about x, y and z, 190 about
    x (w < 0 before the sign is made >= 0), 120 about (1, 1, 1) (all four
    pivots 0: the first wins), 180 about (1, 1, 0) (m00 == m11)."""
    eye = np.eye(3)
    mats = [eye, np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1]),
            R.from_euler("x", 190, degrees=True).as_matrix(),
            np.array([[0.0, 0, 1], [1, 0, 0], [0, 1, 0]]),
            np.array([[0.0, 1, 0], [1, 0, 0], [0, 0, -1]])]
    return np.stack(mats).astype(np.float32)


# name -> (make inputs from rng, JAX call, port call, atol)
CASES = {
    "rotmat_to_quat": (lambda rng: (_rotmats(rng, BATCH),),
                       jg.rotmat_to_quat, tg.rotmat_to_quat, UNIT),
    "rotmat_to_quat_pivots": (lambda rng: (_pivot_cases(),),
                              jg.rotmat_to_quat, tg.rotmat_to_quat, UNIT),
    "yaw_to_quat": (lambda rng: (rng.uniform(-np.pi, np.pi, BATCH).astype(np.float32),),
                    jg.yaw_to_quat, tg.yaw_to_quat, UNIT),
    "quat_to_yaw": (lambda rng: (_quats(rng, BATCH),), jg.quat_to_yaw, tg.quat_to_yaw, UNIT),
    "yaw_rotmat": (lambda rng: (rng.uniform(-np.pi, np.pi, BATCH).astype(np.float32),),
                   jg.yaw_rotmat, tg.yaw_rotmat, UNIT),
    "quat_multiply": (lambda rng: (_quats(rng, BATCH), _quats(rng, BATCH)),
                      jg.quat_multiply, tg.quat_multiply, UNIT),
    "quat_inverse": (lambda rng: (_quats(rng, BATCH),), jg.quat_inverse, tg.quat_inverse, 0.0),
    "transform_matrix": (lambda rng: (_translations(rng, BATCH), _quats(rng, BATCH)),
                         jg.transform_matrix, tg.transform_matrix, METRIC),
    # one rotation for a batch of translations: the two broadcast
    "transform_matrix_broadcast": (lambda rng: (_translations(rng, BATCH), _quats(rng, ())),
                                   jg.transform_matrix, tg.transform_matrix, METRIC),
    "transform_matrix_inverse": (
        lambda rng: (_translations(rng, BATCH), _quats(rng, BATCH)),
        lambda t, q: jg.transform_matrix(t, q, inverse=True),
        lambda t, q: tg.transform_matrix(t, q, inverse=True), METRIC),
    "invert_se3": (lambda rng: (_se3(rng, BATCH),), jg.invert_se3, tg.invert_se3, METRIC),
    "compose": (lambda rng: (_se3(rng, BATCH), _se3(rng, BATCH), _se3(rng, (3,))),
                jg.compose, tg.compose, METRIC),
    "apply_se3": (lambda rng: (_se3(rng, BATCH), _points(rng, BATCH, d=3)),
                  jg.apply_se3, tg.apply_se3, METRIC),
    "remove_close_mask": (lambda rng: (_points(rng, BATCH, scale=3.0), 1.5),
                          jg.remove_close_mask, tg.remove_close_mask, 0.0),
    "rotate_points": (lambda rng: (_points(rng, BATCH), _rotmats(rng, BATCH)),
                      jg.rotate_points, tg.rotate_points, METRIC),
    "translate_points": (lambda rng: (_points(rng, BATCH), _translations(rng, BATCH)),
                         jg.translate_points, tg.translate_points, METRIC),
    "transform_points": (lambda rng: (_points(rng, BATCH), _se3(rng, BATCH)),
                         jg.transform_points, tg.transform_points, METRIC),
}


def _call(fn, args, wrap):
    return fn(*[wrap(a) if isinstance(a, np.ndarray) else a for a in args])


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches_jax(name):
    make, jax_fn, port_fn, atol = CASES[name]
    args = make(np.random.default_rng(sorted(CASES).index(name)))
    want = np.asarray(_call(jax_fn, args, jnp.asarray))
    got = _call(port_fn, args, torch.from_numpy).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_rotmat_to_quat_at_the_pivots():
    """The tie and sign cases land on the quaternions they should: w >= 0
    after the sign flip, unit norm, and the matrix back."""
    q = tg.rotmat_to_quat(torch.from_numpy(_pivot_cases())).numpy()
    assert (q[:, 0] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=UNIT)
    np.testing.assert_allclose(q[5], [0.5, 0.5, 0.5, 0.5], atol=UNIT)  # all pivots tie
    np.testing.assert_allclose(q[6], [0, 0.5 ** 0.5, 0.5 ** 0.5, 0], atol=UNIT)
    np.testing.assert_allclose(tg.quat_to_rotmat(torch.from_numpy(q)).numpy(), _pivot_cases(),
                               atol=1e-6)


def test_transform_matrix_inverse_is_invert_se3():
    """transform_matrix(..., inverse=True) == invert_se3(transform_matrix(...)),
    the devkit helper's contract (reference src/nuscenes/utils/pcd.py:89-93)."""
    rng = np.random.default_rng(7)
    t = torch.from_numpy(_translations(rng, BATCH))
    q = torch.from_numpy(_quats(rng, BATCH))
    np.testing.assert_allclose(tg.transform_matrix(t, q, inverse=True).numpy(),
                               tg.invert_se3(tg.transform_matrix(t, q)).numpy(), rtol=0, atol=0)
    prod = tg.compose(tg.transform_matrix(t, q), tg.transform_matrix(t, q, inverse=True))
    np.testing.assert_allclose(prod.numpy(), np.broadcast_to(np.eye(4), BATCH + (4, 4)),
                               atol=1e-3)


# --- the cases of tests/test_se3.py and tests/test_pointcloud.py, on the port ---

SCIPY_RNG_SEED = 0


def _scipy_rotmat(q_wxyz):
    return R.from_quat(np.roll(q_wxyz, -1, axis=-1)).as_matrix()


def test_rotmat_to_quat_roundtrip_scipy():
    rng = np.random.default_rng(SCIPY_RNG_SEED)
    q = _quats(rng, (64,)).astype(np.float64)
    q = np.where(q[:, :1] < 0, -q, q)
    back = tg.rotmat_to_quat(torch.tensor(_scipy_rotmat(q), dtype=torch.float32)).numpy()
    np.testing.assert_allclose(back, q, atol=1e-5)


def test_yaw_quat_roundtrip_scipy():
    yaws = np.linspace(-np.pi + 1e-3, np.pi - 1e-3, 37)
    q = tg.yaw_to_quat(torch.tensor(yaws, dtype=torch.float32))
    np.testing.assert_allclose(tg.quat_to_yaw(q).numpy(), yaws, atol=1e-5)
    m = tg.yaw_rotmat(torch.tensor(yaws, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(m, R.from_euler("z", yaws[:, None]).as_matrix(), atol=1e-6)


def test_quat_multiply_and_inverse_scipy():
    rng = np.random.default_rng(SCIPY_RNG_SEED + 1)
    q1, q2 = _quats(rng, (16,)), _quats(rng, (16,))
    prod = tg.quat_multiply(torch.from_numpy(q1), torch.from_numpy(q2)).numpy()
    np.testing.assert_allclose(_scipy_rotmat(prod), _scipy_rotmat(q1) @ _scipy_rotmat(q2),
                               atol=1e-5)
    inv = tg.quat_inverse(torch.from_numpy(q1))
    ident = tg.quat_to_rotmat(tg.quat_multiply(torch.from_numpy(q1), inv)).numpy()
    np.testing.assert_allclose(ident, np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-5)


def test_compose_and_apply_scipy():
    rng = np.random.default_rng(SCIPY_RNG_SEED + 2)
    q, t = _quats(rng, (3,)), (rng.normal(size=(3, 3)) * 10).astype(np.float32)
    mats = [tg.transform_matrix(torch.from_numpy(t[i]), torch.from_numpy(q[i]))
            for i in range(3)]
    ref = (mats[0] @ mats[1] @ mats[2]).numpy()
    fused = tg.compose(*mats).numpy()
    np.testing.assert_allclose(fused, ref, atol=1e-4)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    out = tg.apply_se3(torch.from_numpy(fused), torch.from_numpy(pts)).numpy()
    homog = np.concatenate([pts, np.ones((50, 1), np.float32)], -1)
    np.testing.assert_allclose(out, (ref @ homog.T).T[:, :3], atol=1e-3)


def test_remove_close_and_point_ops_scipy():
    """tests/test_pointcloud.py's cases: remove iff |x| < r AND |y| < r
    (reference pcd.py:148-157); rotate / translate / transform the xyz
    columns and pass the others through."""
    pts = np.array([[0.1, 0.1, 5, 1], [5, 0.1, 0, 1], [0.1, 5, 0, 1], [5, 5, 0, 1]], np.float32)
    np.testing.assert_array_equal(tg.remove_close_mask(torch.from_numpy(pts), 1.0).numpy(),
                                  [False, True, True, True])
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(100, 4)).astype(np.float32)
    rot = R.random(random_state=3).as_matrix().astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    out = tg.rotate_points(torch.from_numpy(pts), torch.from_numpy(rot)).numpy()
    np.testing.assert_allclose(out[:, :3], (rot @ pts[:, :3].T).T, atol=1e-5)
    np.testing.assert_array_equal(out[:, 3], pts[:, 3])
    out = tg.translate_points(torch.from_numpy(pts), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out[:, :3], pts[:, :3] + t, atol=1e-6)
    tm = np.eye(4, dtype=np.float32)
    tm[:3, :3], tm[:3, 3] = rot, t
    out = tg.transform_points(torch.from_numpy(pts), torch.from_numpy(tm)).numpy()
    np.testing.assert_allclose(out[:, :3], (rot @ pts[:, :3].T).T + t, atol=1e-5)
    np.testing.assert_array_equal(out[:, 3], pts[:, 3])


# --- medoid_index and PipelineConfig ---

@pytest.mark.parametrize("layout", ["compacted", "scattered"])
def test_medoid_index_matches_jax(layout):
    """The medoid of one point set, equal to JAX's index, with the valid
    rows first (the kernel's precondition on the card) and scattered (the
    plain version takes either)."""
    rng = np.random.default_rng(11)
    for k, count in ((300, 300), (300, 137), (64, 1)):
        pts = (rng.normal(size=(k, 3)) * 20 + rng.uniform(-800, 800, 3)).astype(np.float32)
        valid = np.zeros(k, bool)
        if layout == "compacted":
            valid[:count] = True
        else:
            valid[rng.choice(k, count, replace=False)] = True
        want = np.asarray(jax_medoid_index(jnp.asarray(pts), jnp.asarray(valid)))
        got = medoid_index(torch.from_numpy(pts), torch.from_numpy(valid))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want) and valid[int(got)]


def test_pipeline_config_matches_jax():
    got, want = port_config.PipelineConfig(), jax_config.PipelineConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.classes = ()
