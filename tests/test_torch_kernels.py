"""The port's kernel modules and device ops against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode (as tests/test_compact_pallas.py
and tests/test_medoid_pallas.py do) or its top_k+gather reference. The same
numpy inputs go to both. Compaction and all integer/bool outputs are
exact; medoid sums agree to rtol=1e-5, atol=1e-2 (the bound of
test_medoid_pallas.py), and trig outputs to rtol=1e-6, atol=1e-5.

tests/test_torch_cuda.py holds each CUDA kernel against its plain version
on the card.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_op_cases

from cm3d_tpu.kernels.compact_pallas import compact_rows_pallas
from cm3d_tpu.kernels.medoid_pallas import (
    medoid_distance_sums_pallas,
    medoid_distance_sums_rows_pallas,
)
from cm3d_tpu.ops import bitmask as jax_bitmask
from cm3d_tpu.ops.lanes import nearest_lane as jax_nearest_lane
from cm3d_tpu.ops.lift import _compact_topk
from cm3d_tpu.ops.nms import circle_nms_keep as jax_circle_nms_keep
from cm3d_tpu.ops.pushback import push_centroid as jax_push_centroid

from cm3d_tpu_torch.kernels.compact import TILE as COMPACT_TILE
from cm3d_tpu_torch.kernels.compact import MAX_TILES, compact_rows, plan_tiles
from cm3d_tpu_torch.kernels.medoid import (
    SCRATCH_BYTES,
    TILE,
    medoid_distance_sums,
    medoid_distance_sums_rows,
    rows_per_launch,
)
from cm3d_tpu_torch.ops import bitmask
from cm3d_tpu_torch.ops.lanes import nearest_lane
from cm3d_tpu_torch.ops.medoid import masked_medoid, masked_medoid_rows
from cm3d_tpu_torch.ops.nms import circle_nms_keep
from cm3d_tpu_torch.ops.pushback import push_centroid

TRIG = dict(rtol=1e-6, atol=1e-5)
MEDOID = dict(rtol=1e-5, atol=1e-2)


# ---------------------------------------------------------------- compaction

def _topk_gather(sel, values, limit):
    ids, ok = _compact_topk(jnp.asarray(sel), limit)
    v = jnp.take_along_axis(jnp.asarray(values), ids[:, None, :], axis=2)
    return np.asarray(jnp.where(ok[:, None, :], v, 0.0))


def _compaction_case(case):
    rng = np.random.default_rng(0)
    r, s, d, limit = {
        "mixed": (6, 2048, 3, 512),
        "odd": (5, 1500, 2, 333),
        "limit_equals_s": (3, 700, 4, 700),
    }[case]
    sel = rng.random((r, s)) < 0.3
    sel[1] = False  # empty row
    sel[2] = True  # full row: truncates at limit unless limit == s
    if r > 3:
        sel[3, : s // 2] = False  # selection concentrated late
    values = rng.standard_normal((r, d, s)).astype(np.float32)
    return sel, values, limit


@pytest.mark.parametrize("case", ["mixed", "odd", "limit_equals_s"])
def test_compact_plain_matches_pallas_and_topk(case):
    sel, values, limit = _compaction_case(case)
    got = compact_rows(torch.from_numpy(sel), torch.from_numpy(values), limit).numpy()
    assert got.shape == (sel.shape[0], values.shape[1], limit)
    np.testing.assert_array_equal(got, _topk_gather(sel, values, limit))
    want = np.asarray(compact_rows_pallas(jnp.asarray(sel), jnp.asarray(values),
                                          limit, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_compact_int32_words_exact():
    """Raw 32-bit payloads (point ids, mask words with the sign bit set,
    f32 NaN bit patterns) come out bit for bit."""
    rng = np.random.default_rng(1)
    r, s, limit = 4, 999, 200
    sel = rng.random((r, s)) < 0.4
    words = rng.integers(-(2**31), 2**31 - 1, (r, 2, s), dtype=np.int64).astype(np.int32)
    got = compact_rows(torch.from_numpy(sel), torch.from_numpy(words), limit).numpy()
    for i in range(r):
        idx = np.flatnonzero(sel[i])[:limit]
        want = np.zeros((2, limit), np.int32)
        want[:, : len(idx)] = words[i][:, idx]
        np.testing.assert_array_equal(got[i], want)


def test_compact_rejects_bad_shapes():
    with pytest.raises(ValueError, match="sel"):
        compact_rows(torch.zeros(2, 5, dtype=torch.bool), torch.zeros(2, 3, 4), 3)
    with pytest.raises(TypeError, match="bool"):
        compact_rows(torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 3, 4), 3)


def test_cpu_wrappers_count_no_launch():
    sel, values, limit = _compaction_case("odd")
    before = (compact_rows.launches, medoid_distance_sums_rows.launches)
    compact_rows(torch.from_numpy(sel), torch.from_numpy(values), limit)
    medoid_distance_sums_rows(torch.zeros(2, 3, 8), torch.ones(2, 8, dtype=torch.bool))
    assert (compact_rows.launches, medoid_distance_sums_rows.launches) == before


@pytest.mark.parametrize("sources", [
    131072, 32768, 8192,  # the lift step's three calls
    1, 0, 1025, 16, 2**24 + 3,
])
def test_compact_tile_plan_covers_every_source_once(sources):
    """The scatter kernel's tiles [k * tile, min((k + 1) * tile, S)) of the
    plan cover each source of a row once, each tile holds a source (one
    tile for an empty row), the 16-byte loads stay aligned, and a row has at
    most MAX_TILES tiles, of COMPACT_TILE sources wherever that is enough."""
    tile, n = plan_tiles(sources)
    assert tile % 16 == 0 and 1 <= n <= MAX_TILES
    assert tile == COMPACT_TILE or sources > COMPACT_TILE * MAX_TILES
    starts = np.arange(n, dtype=np.int64) * tile
    ends = np.minimum(starts + tile, sources)
    assert starts[0] == 0 and ends[-1] == sources
    assert np.all(starts[1:] == ends[:-1]) and (sources == 0 or np.all(ends > starts))


# ------------------------------------------------------------------- medoid

def _medoid_case(r, k, counts, scale, offset, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-scale, scale, (r, k, 3)) + offset).astype(np.float32)
    valid = np.arange(k)[None, :] < np.asarray(counts)[:, None]
    return pts, valid


def _ref_sums(pts, valid):
    p = pts.astype(np.float64) * valid[:, None]
    d = np.sqrt(((p[:, None, :] - p[None, :, :]) ** 2).sum(-1))
    return (d * valid[None, :]).sum(1)


@pytest.mark.parametrize("k,counts,scale,offset", [
    (512, [512, 300, 37, 1, 0], 30.0, 0.0),     # full, partial tile, tiny, one, empty
    (300, [300, 123, 2], 5.0, 1000.0),          # K off the tile; global-frame offset
])
def test_medoid_sums_match_pallas_and_numpy(k, counts, scale, offset):
    pts, valid = _medoid_case(len(counts), k, counts, scale, offset, seed=k)
    rows = np.ascontiguousarray(pts.transpose(0, 2, 1))
    got = medoid_distance_sums_rows(torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    got_kn3 = medoid_distance_sums(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got_kn3, got)
    pallas = np.asarray(medoid_distance_sums_rows_pallas(
        jnp.asarray(rows), jnp.asarray(valid), interpret=True))
    pallas_kn3 = np.asarray(medoid_distance_sums_pallas(
        jnp.asarray(pts), jnp.asarray(valid), interpret=True))
    for i, c in enumerate(counts):
        ref = _ref_sums(pts[i], valid[i])
        # only the first `count` rows are meaningful (argmin masks the rest)
        np.testing.assert_allclose(got[i, :c], ref[:c], **MEDOID)
        np.testing.assert_allclose(got[i, :c], pallas[i, :c], **MEDOID)
        np.testing.assert_allclose(got[i, :c], pallas_kn3[i, :c], **MEDOID)


def test_medoid_index_matches_exact_argmin_without_near_ties():
    """The medoid index equals the float64 argmin wherever the two smallest
    exact sums differ by more than 1e-5 relative."""
    counts = [400, 250, 77, 9, 1, 0]
    pts, valid = _medoid_case(len(counts), 400, counts, 20.0, 800.0, seed=5)
    rows = torch.from_numpy(np.ascontiguousarray(pts.transpose(0, 2, 1)))
    got = masked_medoid_rows(rows, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(
        masked_medoid(torch.from_numpy(pts), torch.from_numpy(valid)).numpy(), got)
    checked = 0
    for i, c in enumerate(counts):
        if c == 0:
            assert got[i] == 0
            continue
        ref = _ref_sums(pts[i], valid[i])[:c]
        two = np.sort(ref)[:2]
        if c > 1 and two[1] - two[0] <= 1e-5 * abs(two[0]):
            continue
        assert got[i] == int(np.argmin(ref))
        checked += 1
    assert checked >= 4


def test_medoid_rows_per_launch_bounds_the_scratch():
    """One launcher call takes a whole batch-8 lift step (1024 rows of 2048
    points); the partial sums [rows, ceil(K / TILE), K] f32 of a call stay
    within SCRATCH_BYTES, and a call takes at least one row."""
    assert rows_per_launch(2048) >= 1024
    for k in (1, 127, 128, 300, 2048, 100_000, 1 << 20):
        n = rows_per_launch(k)
        assert n >= 1
        assert n == 1 or n * -(-k // TILE) * k * 4 <= SCRATCH_BYTES
        assert (n + 1) * -(-k // TILE) * k * 4 > SCRATCH_BYTES


def _tile_pair(q):
    """csrc/medoid.cu's numbering of a row's tile pairs: q = b (b + 1) / 2 + a, a <= b."""
    b = int((math.sqrt(8.0 * q + 1.0) - 1.0) * 0.5)
    while b * (b + 1) // 2 > q:
        b -= 1
    while (b + 1) * (b + 2) // 2 <= q:
        b += 1
    return q - b * (b + 1) // 2, b


@pytest.mark.parametrize("k,counts", [
    (300, [300, 129, 128, 127, 1, 0]),  # tile edges, K off the tile
    (1024, [1024, 1000, 640, 257]),
])
def test_medoid_tile_pair_schedule_sums_each_pair_once(k, counts):
    """The kernel's schedule, replayed in numpy f32: the tile pairs (a, b),
    a <= b, of a row cover every pair of tiles once; an off-diagonal pair
    adds each distance to a row sum of tile a and a column sum of tile b
    (partial sums part[b, i] and part[a, j]), a diagonal pair takes the pairs
    j > i of its tile and adds a point's two sums (part[a, i]); summed over
    the tiles in order they give the plain version's sums (rtol 1e-5), and
    every unordered pair of distinct points is computed once."""
    pts, valid = _medoid_case(len(counts), k, counts, 30.0, 800.0, seed=k)
    rows = np.ascontiguousarray(pts.transpose(0, 2, 1))
    want = medoid_distance_sums_rows(torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    for r, c in enumerate(counts):
        nt = -(-c // TILE)
        pairs = [_tile_pair(q) for q in range(nt * (nt + 1) // 2)]
        assert pairs == [(a, b) for b in range(nt) for a in range(b + 1)]
        p = pts[r, :c]
        part = np.zeros((nt, c), np.float32)
        seen = np.zeros((c, c), np.int64)
        for a, b in pairs:
            ia, jb = slice(a * TILE, (a + 1) * TILE), slice(b * TILE, (b + 1) * TILE)
            diff = p[ia, None, :] - p[None, jb, :]
            d = np.sqrt((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
                        + diff[..., 2] * diff[..., 2])
            if a == b:  # j > i only
                d = np.triu(d, 1)
                seen[ia, jb] += np.triu(np.ones_like(d, np.int64), 1)
                part[a, ia] = d.sum(1, dtype=np.float32) + d.sum(0, dtype=np.float32)
            else:
                seen[ia, jb] += 1
                part[b, ia] = d.sum(1, dtype=np.float32)
                part[a, jb] = d.sum(0, dtype=np.float32)
        distinct = ~np.eye(c, dtype=bool)
        assert (seen + seen.T)[distinct].tolist() == [1] * int(distinct.sum())
        got = np.zeros(c, np.float32)
        for t in range(nt):
            got += part[t]
        np.testing.assert_allclose(got, want[r, :c], rtol=1e-5)


# ------------------------------------------------------------ device ops

def _mask_words(seed, w=37, h=23, m=45):
    rng = np.random.default_rng(seed)
    masks = rng.random((m, w, h)) < 0.7
    return jax_bitmask.pack_masks_np(masks)


def test_pack_unpack_copies_match_jax():
    rng = np.random.default_rng(2)
    masks = rng.random((45, 17, 11)) < 0.5
    words = bitmask.pack_masks_np(masks)
    np.testing.assert_array_equal(words, jax_bitmask.pack_masks_np(masks))
    np.testing.assert_array_equal(bitmask.unpack_masks_np(words, 45), masks)
    assert bitmask.num_words(45) == jax_bitmask.num_words(45) == 2


@pytest.mark.parametrize("batched", [False, True])
def test_erode3x3_packed_matches_jax(batched):
    words = _mask_words(4)
    if batched:
        words = np.stack([words, _mask_words(5)])
    want = np.asarray(jax_bitmask.erode3x3_packed(jnp.asarray(words)))
    got = bitmask.erode3x3_packed(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_extract_bit_matches_jax():
    rng = np.random.default_rng(6)
    rows = rng.integers(0, 2**32, (40, 50), dtype=np.uint64).astype(np.uint32)
    ids = np.arange(40, dtype=np.int32)
    want = np.asarray(jax_bitmask.extract_bit(jnp.asarray(rows), jnp.asarray(ids)))
    got = bitmask.extract_bit(torch.from_numpy(rows.view(np.int32)), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lanes", ["some", "none"])
def test_nearest_lane_matches_jax(lanes):
    rng = np.random.default_rng(8)
    cent = rng.uniform(-50, 50, (30, 2)).astype(np.float32)
    lp = np.concatenate([rng.uniform(-60, 60, (64, 2)), rng.uniform(-3, 3, (64, 1))],
                        axis=1).astype(np.float32)
    lp[10] = lp[3]  # duplicate point: first-index tie-break
    valid = rng.random(64) < 0.6 if lanes == "some" else np.zeros(64, bool)
    want = jax_nearest_lane(jnp.asarray(cent), jnp.asarray(lp), jnp.asarray(valid))
    got = nearest_lane(torch.from_numpy(cent), torch.from_numpy(lp), torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRIG)
    if lanes == "none":
        assert np.isinf(got[1].numpy()).all() and (got[0].numpy() == 0).all()


def test_push_centroid_matches_jax():
    rng = np.random.default_rng(9)
    cent = (rng.uniform(-40, 40, (64, 3)) + [500.0, -300.0, 0.0]).astype(np.float32)
    ext = rng.uniform(0.3, 12.0, (64, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    ego = np.array([500.0, -300.0, 0.0], np.float32)
    want = np.asarray(jax_push_centroid(jnp.asarray(cent), jnp.asarray(ext),
                                        jnp.asarray(yaw), jnp.asarray(ego)))
    got = push_centroid(torch.from_numpy(cent), torch.from_numpy(ext),
                        torch.from_numpy(yaw), torch.from_numpy(ego)).numpy()
    np.testing.assert_allclose(got, want, **TRIG)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_circle_nms_keep_matches_jax(seed):
    """Dense clusters with tied scores and mixed labels: the keep sets are
    identical (stable descending sort; squared radius of the suppressed
    box's class)."""
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.uniform(0, 6, (n, 2)).astype(np.float32)
    scores = rng.choice([0.3, 0.5, 0.7, 0.9], n).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    radii = np.array([4.0, 12.0, 10.0, 10.0, 12.0, 0.175, 0.85, 0.85, 0.175, 1.0],
                     np.float32)
    want = np.asarray(jax_circle_nms_keep(jnp.asarray(xy), jnp.asarray(scores),
                                          jnp.asarray(labels), jnp.asarray(valid),
                                          jnp.asarray(radii)))
    got = circle_nms_keep(torch.from_numpy(xy), torch.from_numpy(scores),
                          torch.from_numpy(labels), torch.from_numpy(valid),
                          torch.from_numpy(radii)).numpy()
    assert 0 < want.sum() < valid.sum()  # suppression happened
    np.testing.assert_array_equal(got, want)


# ---- the kernels as dispatcher ops (kernels/ops.py) ---------------------


@pytest.mark.parametrize("case", torch_op_cases.case_ids())
def test_opcheck_every_registered_op(case):
    """torch.library.opcheck on the CPU: the schema (no input mutated or
    aliased), no autograd kernel behind a backend key, the fake
    implementation's shapes, dtypes and strides against the plain
    version's, and AOT dispatch with dynamic shapes."""
    op, dtype = torch_op_cases.CASES[torch_op_cases.case_ids().index(case)]
    overload, args = torch_op_cases.op_and_args(op, dtype, "cpu")
    torch.library.opcheck(overload, args)


def test_every_launcher_is_an_op():
    """The namespace holds exactly the launchers of the six kernel modules
    (every one with an opcheck case), and each wrapper's CPU call goes
    through its op and launches nothing."""
    import cm3d_tpu_torch.kernels.sam_global_attn  # noqa: F401
    import cm3d_tpu_torch.kernels.window_attn_relpos  # noqa: F401
    from cm3d_tpu_torch.kernels import ops

    defined = {name.split("::")[1].split(".")[0]
               for name in torch._C._dispatch_get_all_op_names()
               if name.startswith(f"{ops.NAMESPACE}::")}
    assert defined == {op for op, _ in torch_op_cases.CASES}


def _greedy_keep_loop(overlap, valid_sorted):
    """The fixpoint as it was written before the traced form: whole-vector
    sweeps until one changes nothing."""
    n = overlap.shape[-1]
    upper = torch.ones((n, n), dtype=torch.bool).triu(1)
    ov = overlap & upper & valid_sorted[..., :, None]
    keep = valid_sorted
    while True:
        new = valid_sorted & ~(ov & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            return keep
        keep = new


def _greedy_keep_sequential(overlap, valid_sorted):
    """Greedy NMS one box at a time (the definition)."""
    ov, val = overlap.numpy(), valid_sorted.numpy()
    keep = np.zeros_like(val)
    for idx in np.ndindex(val.shape[:-1]):
        for j in range(val.shape[-1]):
            keep[idx + (j,)] = val[idx + (j,)] and not any(
                keep[idx + (i,)] and ov[idx + (i, j)] for i in range(j))
    return torch.from_numpy(keep)


class _Fixpoint(torch.nn.Module):
    def forward(self, overlap, valid_sorted):
        from cm3d_tpu_torch.ops.nms import _greedy_keep_fixpoint

        return _greedy_keep_fixpoint(overlap, valid_sorted)


def _overlaps(seed, batch=3, n=24):
    """Random overlap matrices with chains of suppression: box i overlaps
    i + 1 along a chain (keep alternates down it) beside random pairs."""
    rng = np.random.default_rng(seed)
    ov = rng.random((batch, n, n)) < 0.08
    for b in range(batch):
        start = int(rng.integers(0, n // 2))
        for i in range(start, n - 1):
            ov[b, i, i + 1] = True
    valid = rng.random((batch, n)) < 0.9
    return torch.from_numpy(ov), torch.from_numpy(valid)


def test_greedy_keep_fixpoint_traced_equals_the_loop():
    """The exported form (torch.export, a while_loop over (keep, previous
    keep)) keeps exactly the boxes the eager sweep loop and the one-at-a-
    time definition keep, on chains of suppression up to n long; the eager
    form is the loop itself."""
    from cm3d_tpu_torch.ops.nms import _greedy_keep_fixpoint

    ov, valid = _overlaps(0)
    with torch.no_grad():
        traced = torch.export.export(_Fixpoint(), (ov, valid)).module()
    for seed in range(6):
        ov, valid = _overlaps(seed)
        want = _greedy_keep_loop(ov, valid)
        torch.testing.assert_close(want, _greedy_keep_sequential(ov, valid))
        torch.testing.assert_close(_greedy_keep_fixpoint(ov, valid), want)
        torch.testing.assert_close(traced(ov, valid), want)
    # a chain over the whole axis: n - 1 suppressions, n / 2 kept
    full = torch.zeros(3, 24, 24, dtype=torch.bool)
    full[:, torch.arange(23), torch.arange(1, 24)] = True
    every = torch.ones(3, 24, dtype=torch.bool)
    assert traced(full, every).sum(-1).tolist() == [12, 12, 12]
    torch.testing.assert_close(traced(full, every), _greedy_keep_loop(full, every))


class _CircleNms(torch.nn.Module):
    def forward(self, xy, scores, labels, valid, radii):
        return circle_nms_keep(xy, scores, labels, valid, radii)


def test_exported_circle_nms_matches_jax():
    """circle_nms_keep traced by torch.export against the JAX package's
    circle_nms_keep (a lax.while_loop) on dense clusters with tied scores."""
    radii = torch.tensor([4.0, 12.0, 10.0, 10.0, 12.0, 0.175, 0.85, 0.85, 0.175, 1.0])
    n = 60

    def inputs(seed):
        rng = np.random.default_rng(seed)
        return (rng.uniform(0, 6, (2, n, 2)).astype(np.float32),
                rng.choice([0.3, 0.5, 0.7, 0.9], (2, n)).astype(np.float32),
                rng.integers(0, 10, (2, n)).astype(np.int32), rng.random((2, n)) < 0.85)

    with torch.no_grad():
        traced = torch.export.export(
            _CircleNms(), (*map(torch.from_numpy, inputs(0)), radii)).module()
    for seed in range(3):
        xy, scores, labels, valid = inputs(seed)
        want = np.stack([np.asarray(jax_circle_nms_keep(
            jnp.asarray(xy[b]), jnp.asarray(scores[b]), jnp.asarray(labels[b]),
            jnp.asarray(valid[b]), jnp.asarray(radii.numpy()))) for b in range(2)])
        got = traced(*map(torch.from_numpy, (xy, scores, labels, valid)), radii).numpy()
        assert 0 < want.sum() < valid.sum()
        np.testing.assert_array_equal(got, want)


def test_erode3x3_matches_jax():
    """The unpacked 3x3 erosion against the JAX package's erode3x3 on the
    masks of tests/test_ops.py (uint8) and as bool: exact, dtype kept."""
    from cm3d_tpu.ops.erosion import erode3x3 as jax_erode3x3

    from cm3d_tpu_torch.ops.erosion import erode3x3

    masks = (np.random.default_rng(42).random((5, 64, 48)) > 0.4).astype(np.uint8)
    for m in (masks, masks.astype(bool), masks[0]):
        got = erode3x3(torch.from_numpy(m))
        assert got.dtype == torch.from_numpy(m).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_erode3x3(jnp.asarray(m))))
