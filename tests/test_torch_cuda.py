"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips where there is no CUDA device. This file
imports neither JAX nor cm3d_tpu, so it runs on a machine with only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Compaction must be bit-exact on raw 32-bit words; medoid sums agree to
rtol=1e-5 on valid rows (each pairwise distance rounds alike, only the
summation order differs) and give equal bits on a second call. Window attention (both launches) agrees with its
plain version to 1e-4 of the output's largest magnitude in f32 (only the
summation order and exp/rsqrt rounding differ) and to 2^-5 of it in bf16,
four bf16 ulps at the top of the range: the two sides round qkv, p, o and
out at the same places, but a last-bit difference in an f32 sum can move a
bf16 rounding by one ulp. SAM's rel-pos window attention is held to the same
two tolerances. The segment kernels agree with their plain scatter versions to
rtol 1e-5 / atol 1e-5 in the sums (addition order), exactly in maxima, empty
cells, the sink and the gather backward, and give equal bits twice in a row.
Window attention under autograd returns the plain branch's gradients (its
backward IS the plain branch, recomputed on the card). The bf16 GEMM (wgmma,
TMA) behind the qkv product and the projection is held alone to the f32
plain version on bf16-rounded inputs at 2^-5 of the largest magnitude, and
gives equal bits twice.
"""

import json

import numpy as np
import pytest
import torch

import torch_op_cases

from cm3d_tpu_torch.kernels.compact import compact_rows, compact_rows_plain
from cm3d_tpu_torch.kernels.medoid import (
    medoid_distance_sums,
    medoid_distance_sums_rows,
    medoid_distance_sums_rows_plain,
)
from cm3d_tpu_torch.kernels.segment import (
    segment_sum,
    segment_sum_bwd,
    segment_sum_bwd_plain,
    segment_sum_max,
    segment_sum_max_plain,
    segment_sum_plain,
)
from cm3d_tpu_torch.kernels.window_attn import (
    window_attn,
    window_attn_heads,
    window_attn_heads_plain,
    window_attn_plain,
    window_attn_proj,
    window_attn_proj_plain,
    window_attn_qkv,
    window_attn_qkv_plain,
)
from cm3d_tpu_torch.kernels.window_attn_relpos import (
    window_attn_relpos,
    window_attn_relpos_heads,
    window_attn_relpos_heads_plain,
    window_attn_relpos_plain,
    window_attn_relpos_proj,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("r,s,d,limit,p", [
    (6, 2048, 3, 512, 0.3),
    (5, 1500, 2, 333, 0.5),  # odd S and L
    (3, 700, 4, 700, 0.9),  # L == S
    (2, 1, 1, 1, 1.0),  # one source
    (40, 40000, 5, 9000, 0.2),  # many chunks per row, truncation
])
def test_compact_kernel_matches_plain(cuda, r, s, d, limit, p):
    rng = np.random.default_rng(r * s)
    sel = rng.random((r, s)) < p
    sel[0] = False  # empty row
    if r > 1:
        sel[1] = True  # full row
    words = rng.integers(-(2**31), 2**31 - 1, (r, d, s), dtype=np.int64).astype(np.int32)
    sel_d, words_d = torch.from_numpy(sel).to(cuda), torch.from_numpy(words).to(cuda)
    before = compact_rows.launches
    got = compact_rows(sel_d, words_d, limit)
    torch.cuda.synchronize()
    assert compact_rows.launches == before + 1
    assert torch.equal(got, compact_rows_plain(sel_d, words_d, limit))
    # f32 payloads ride as their bit patterns
    vals = words_d.view(torch.float32)
    assert torch.equal(compact_rows(sel_d, vals, limit).view(torch.int32),
                       compact_rows_plain(sel_d, vals, limit).view(torch.int32))


def _compact_twice(cuda, sel, d, limit, seed=0):
    """Two calls of the kernel on random words: bit-equal to the plain
    version and to each other, one counted launch each."""
    rng = np.random.default_rng(seed)
    r, s = sel.shape
    words = rng.integers(-(2**31), 2**31 - 1, (r, d, s), dtype=np.int64).astype(np.int32)
    sel_d, words_d = torch.from_numpy(sel).to(cuda), torch.from_numpy(words).to(cuda)
    before = compact_rows.launches
    got = compact_rows(sel_d, words_d, limit)
    again = compact_rows(sel_d, words_d, limit)
    torch.cuda.synchronize()
    assert compact_rows.launches == before + 2
    assert torch.equal(got, compact_rows_plain(sel_d, words_d, limit))
    assert torch.equal(again, got)


def _edge_rows(rng, s, limit):
    """Rows that meet the kernel's edges: empty, full (truncated inside the
    first tile when limit is), dense, sparse, exactly `limit` kept, and one
    contiguous block."""
    sel = np.zeros((6, s), bool)
    sel[1] = True
    sel[2] = rng.random(s) < 0.5
    sel[3] = rng.random(s) < 0.05
    sel[4, rng.permutation(s)[:min(limit, s)]] = True
    sel[5, s // 3: 2 * s // 3] = True
    return sel


@pytest.mark.parametrize("tile,s", [
    (1024, 1023), (1024, 1024), (1024, 1025),  # S at a tile size -1, 0, +1
    (4096, 4095), (4096, 4097),  # one scatter pass a tile, and a second
    (8192, 8191), (8192, 16385),  # two passes a tile
    (16, 33), (1040, 3000),  # the smallest tile; a tile no power of two
])
@pytest.mark.parametrize("where", ["none", "first_tile", "second_tile"])
def test_compact_kernel_at_tile_edges(cuda, monkeypatch, tile, s, where):
    """Every tile plan the launcher takes, with the limit past the count, in
    the first tile and in the second."""
    import cm3d_tpu_torch.kernels.compact as compact

    monkeypatch.setattr(compact, "plan_tiles",
                        lambda sources: (tile, max(1, -(-sources // tile))))
    limit = {"none": s, "first_tile": tile // 2 + 3, "second_tile": tile + 5}[where]
    rng = np.random.default_rng(tile + s)
    _compact_twice(cuda, _edge_rows(rng, s, limit), 3, limit, seed=s)


def test_compact_kernel_on_empty_rows_and_unaligned_selection(cuda):
    # a call whose rows are all empty: every slot 0
    sel = torch.zeros((7, 5000), dtype=torch.bool, device=cuda)
    words = torch.arange(7 * 2 * 5000, dtype=torch.int32, device=cuda).reshape(7, 2, 5000)
    out = compact_rows(sel, words, 4000)
    assert bool((out == 0).all())
    # a selection that starts one byte into its buffer reads byte by byte
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.random(1 + 4 * 8192) < 0.3).to(cuda)
    sel = flat[1:].view(4, 8192)
    assert sel.data_ptr() % 16 == 1 and sel.is_contiguous()
    words = torch.from_numpy(rng.integers(0, 2**31 - 1, (4, 2, 8192)).astype(np.int32)).to(cuda)
    assert torch.equal(compact_rows(sel, words, 3000), compact_rows_plain(sel, words, 3000))


@pytest.mark.parametrize("r,s,d,limit,density", [
    (48, 131072, 5, 32768, 0.35),  # camera stage of a batch-8 lift step
    (48, 32768, 8, 8192, 0.25),  # union stage
    (1024, 8192, 4, 2048, 0.02),  # mask stage
    (8, 131072, 5, 32768, 0.35),  # KITTI's camera stage: one camera a keyframe
    (8, 32768, 8, 8192, 0.25),  # KITTI's union stage
])
def test_compact_kernel_at_production_shapes(cuda, r, s, d, limit, density):
    """The lift step's three calls through the wrapper's own tile plan, on
    seeded selections: a block of the row (a camera's field of view, a
    mask's points) at the given density, some rows past the limit."""
    rng = np.random.default_rng(r + s)
    sel = np.zeros((r, s), bool)
    for i in range(r):
        width = int(s * min(1.0, 2 * density * rng.uniform(0.5, 1.5)))
        lo = rng.integers(0, s - width + 1)
        sel[i, lo:lo + width] = rng.random(width) < 0.5
    _compact_twice(cuda, sel, d, limit, seed=r)


@pytest.mark.parametrize("k,counts,offset", [
    (512, [512, 300, 37, 1, 0], 0.0),
    (2048, [2048, 1999, 256, 255, 257], 1000.0),  # global-frame coordinates
    # either side of the kernels' 128-point tile edges, a full K = 2048 row
    (2048, [127, 128, 129, 383, 384, 385, 1663, 2047, 2048], 500.0),
    (300, [300, 129, 2, 0], 0.0),  # K off the tile
])
def test_medoid_kernel_matches_plain(cuda, k, counts, offset):
    rng = np.random.default_rng(k)
    pts = (rng.uniform(-30, 30, (len(counts), k, 3)) + offset).astype(np.float32)
    valid = np.arange(k)[None, :] < np.asarray(counts)[:, None]
    pts_d = torch.from_numpy(pts).to(cuda)
    valid_d = torch.from_numpy(valid).to(cuda)
    rows = pts_d.transpose(1, 2).contiguous()
    before = medoid_distance_sums_rows.launches
    got = medoid_distance_sums_rows(rows, valid_d)
    got_kn3 = medoid_distance_sums(pts_d, valid_d)
    torch.cuda.synchronize()
    assert medoid_distance_sums_rows.launches == before + 2
    assert torch.equal(got_kn3, got)
    want = medoid_distance_sums_rows_plain(rows, valid_d)
    torch.testing.assert_close(got[valid_d], want[valid_d], rtol=1e-5, atol=0.0)


def _medoid_inputs(k, counts, offset, device):
    rng = np.random.default_rng(len(counts) * k)
    pts = (rng.uniform(-30, 30, (len(counts), k, 3)) + offset).astype(np.float32)
    valid = np.arange(k)[None, :] < np.asarray(counts)[:, None]
    return (torch.from_numpy(pts).to(device).transpose(1, 2).contiguous(),
            torch.from_numpy(valid).to(device))


def test_medoid_kernel_gives_equal_bits_twice(cuda):
    """No f32 atomics: two calls on the same input give the same bits, at
    the lift's batch-8 shape (1024 rows of 2048 points)."""
    counts = np.random.default_rng(1).integers(0, 2049, 1024)
    rows, valid = _medoid_inputs(2048, counts, 800.0, cuda)
    first = medoid_distance_sums_rows(rows, valid)
    second = medoid_distance_sums_rows(rows, valid)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_medoid_kernel_splits_rows_over_launches(cuda, monkeypatch):
    """Rows whose partial sums exceed SCRATCH_BYTES go over several launcher
    calls, each counted, with the bits of one call."""
    import cm3d_tpu_torch.kernels.medoid as medoid

    rows, valid = _medoid_inputs(512, [512, 300, 129, 0, 1, 257, 128], 0.0, cuda)
    whole = medoid_distance_sums_rows(rows, valid)
    monkeypatch.setattr(medoid, "SCRATCH_BYTES", 2 * 4 * 512 * 4)  # two rows a call
    before = medoid_distance_sums_rows.launches
    split = medoid_distance_sums_rows(rows, valid)
    torch.cuda.synchronize()
    assert medoid_distance_sums_rows.launches == before + 4
    assert torch.equal(split, whole)


def test_cuda_wrappers_reject_bad_input(cuda):
    with pytest.raises(TypeError, match="32-bit"):
        compact_rows(torch.ones(2, 4, dtype=torch.bool, device=cuda),
                     torch.zeros(2, 1, 4, dtype=torch.float64, device=cuda), 2)
    with pytest.raises(TypeError, match="f32"):
        medoid_distance_sums_rows(torch.zeros(2, 3, 4, dtype=torch.float64, device=cuda),
                                  torch.ones(2, 4, dtype=torch.bool, device=cuda))


def _window_attn_inputs(rng, b, h, w, c, heads, win, x_dtype, device):
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    return (
        t(rng.standard_normal((b, h, w, c)), x_dtype),
        t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
        t(rng.standard_normal((3 * c, c)) / np.sqrt(c)), t(0.1 * rng.standard_normal(3 * c)),
        t(rng.standard_normal((c, c)) / np.sqrt(c)), t(0.1 * rng.standard_normal(c)),
        t(0.5 * rng.standard_normal(((2 * win - 1) ** 2, heads))),
    )


@pytest.mark.parametrize("b,h,w,c,heads,win,shift,x_dtype,dtype", [
    (2, 8, 8, 16, 2, 4, 0, torch.float32, torch.float32),  # no padding
    (2, 8, 12, 16, 2, 4, 2, torch.float32, torch.float32),  # shift, 3 windows a row
    (1, 10, 13, 32, 4, 4, 2, torch.float32, torch.float32),  # padding + shift
    (2, 14, 21, 32, 2, 7, 3, torch.float32, torch.float32),
    (2, 9, 15, 16, 2, 3, 1, torch.float32, torch.bfloat16),  # f32 x, bf16 compute
    (1, 20, 30, 128, 4, 7, 3, torch.float32, torch.bfloat16),  # Swin-B stage 0 widths
    (1, 21, 35, 256, 8, 7, 0, torch.bfloat16, torch.bfloat16),  # stage 1 widths
    (2, 18, 32, 1024, 32, 7, 3, torch.bfloat16, torch.bfloat16),  # stage 3 at 576x1024
    # M (padded tokens) no multiple of the GEMM's 128 rows, 3C = 288 no
    # multiple of its 128 columns: Swin-T's C 96
    (2, 14, 21, 96, 3, 7, 3, torch.float32, torch.float32),
    (2, 14, 21, 96, 3, 7, 3, torch.bfloat16, torch.bfloat16),
    (2, 13, 19, 128, 4, 7, 0, torch.float32, torch.bfloat16),  # f32 x under bf16, C 128
    (1, 36, 64, 512, 16, 7, 3, torch.bfloat16, torch.bfloat16),  # Swin-B stage 2
    (4, 5, 8, 96, 3, 5, 0, torch.float32, torch.bfloat16),  # the shrunk window 5
])
def test_window_attn_kernel_matches_plain(cuda, b, h, w, c, heads, win, shift, x_dtype, dtype):
    rng = np.random.default_rng(b * h * w * c + shift)
    args = _window_attn_inputs(rng, b, h, w, c, heads, win, x_dtype, cuda)
    kw = dict(heads=heads, window=win, shift=shift, dtype=dtype)
    before = (window_attn_heads.launches, window_attn_proj.launches)
    got = window_attn(*args, **kw)
    got_o = window_attn_heads(*args[:5], args[7], **kw)
    torch.cuda.synchronize()
    assert (window_attn_heads.launches, window_attn_proj.launches) == (before[0] + 2,
                                                                      before[1] + 1)
    want = window_attn_plain(*args, **kw)
    want_o = window_attn_heads_plain(*args[:5], args[7], **kw)
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    for g, ref in ((got_o, want_o), (got, want)):
        err = float((g.float() - ref.float()).abs().max())
        assert err <= tol * float(ref.float().abs().max()), (err, tol)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("h,w,c,heads", [(80, 256, 128, 4), (40, 128, 256, 8),
                                         (20, 64, 512, 16), (10, 32, 1024, 32)])
def test_window_attn_kernel_at_kitti_shapes(cuda, h, w, c, heads, shift):
    """Swin-B's 8 (stage, shift) shapes on a KITTI frame: a 1024 x 309 or
    310 thumbnail pads to 320 x 1024, one camera, bf16."""
    rng = np.random.default_rng(h * w + shift)
    args = _window_attn_inputs(rng, 1, h, w, c, heads, 7, torch.bfloat16, cuda)
    kw = dict(heads=heads, window=7, shift=shift, dtype=torch.bfloat16)
    got = window_attn(*args, **kw)
    torch.cuda.synchronize()
    want = window_attn_plain(*args, **kw).float()
    assert got.shape == (1, h, w, c)
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -5 * float(want.abs().max()), err


@pytest.mark.parametrize("b,h,w,c,heads,win,shift,dtype", [
    (1, 36, 64, 1280, 16, 14, 0, torch.bfloat16),  # SAM ViT-H's rect grid, n = 196
    (1, 20, 30, 160, 2, 14, 0, torch.float32),
    (2, 10, 13, 16, 2, 4, 2, torch.bfloat16),  # C 16
    (2, 14, 21, 96, 3, 7, 3, torch.bfloat16),
])
def test_window_attn_proj_kernel_matches_plain(cuda, b, h, w, c, heads, win, shift, dtype):
    rng = np.random.default_rng(b * h * w * c + win)
    hp, wp = -(-h // win) * win, -(-w // win) * win
    o = torch.from_numpy(rng.standard_normal((b * hp * wp, c)).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    wproj = torch.from_numpy((rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    bproj = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    kw = dict(out_shape=(b, h, w, c), window=win, shift=shift, dtype=dtype)
    before = window_attn_proj.launches
    got = window_attn_proj(o, wproj, bproj, heads=heads, **kw)
    torch.cuda.synchronize()
    assert window_attn_proj.launches == before + 1
    want = window_attn_proj_plain(o, wproj, bproj, **kw)
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attn_kernels_give_equal_bits_twice(cuda, dtype):
    """No atomics in any sum: the same inputs give the same bits."""
    rng = np.random.default_rng(11)
    args = _window_attn_inputs(rng, 2, 20, 30, 128, 4, 7, torch.float32, cuda)
    kw = dict(heads=4, window=7, shift=3, dtype=dtype)
    first = (window_attn_heads(*args[:5], args[7], **kw), window_attn(*args, **kw))
    second = (window_attn_heads(*args[:5], args[7], **kw), window_attn(*args, **kw))
    rel = _relpos_inputs(rng, 1, 20, 30, 128, 2, 14, torch.float32, cuda)
    rkw = dict(heads=2, window=14, dtype=dtype)
    first += (window_attn_relpos(*rel, **rkw),)
    second += (window_attn_relpos(*rel, **rkw),)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_window_attn_wrapper_rejects_bad_input(cuda):
    rng = np.random.default_rng(0)
    args = _window_attn_inputs(rng, 1, 8, 8, 16, 2, 4, torch.float32, cuda)
    kw = dict(heads=2, window=4, shift=0)
    with pytest.raises(TypeError, match="f32 x"):
        window_attn(args[0].double(), *args[1:], dtype=torch.float32, **kw)
    with pytest.raises(TypeError, match="f32 x"):  # bf16 x under f32 compute
        window_attn(args[0].bfloat16(), *args[1:], dtype=torch.float32, **kw)
    with pytest.raises(TypeError, match="compute dtype"):
        window_attn(*args, dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        window_attn(args[0].transpose(1, 2), *args[1:], dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        window_attn(*args, dtype=torch.float32, heads=3, window=4, shift=0)


BF16_TOL = 2.0 ** -5  # bf16 kernel vs f32 plain on bf16-rounded inputs, x max|plain|


def _bf16_close(got, ref):
    err = float((got.float() - ref).abs().max())
    assert err <= BF16_TOL * float(ref.abs().max()), err


# M (padded tokens) is no multiple of the GEMM's 128 rows in any of these
@pytest.mark.parametrize("b,h,w,c,win,shift,x_dtype", [
    (2, 14, 21, 96, 7, 3, torch.float32),  # K 96, N 288: Swin-T's stage 0, shifted
    (1, 10, 13, 96, 7, 3, torch.bfloat16),  # shift 3 over a padded grid, bf16 x
    (4, 5, 8, 96, 5, 0, torch.float32),  # the shrunk window of 5
    (1, 20, 30, 128, 7, 3, torch.bfloat16),  # Swin-B stage 0 width
    (1, 36, 64, 1280, 14, 0, torch.float32),  # ViT-H's rect grid: K 1280, N 3840
])
def test_bf16_qkv_gemm_matches_plain(cuda, b, h, w, c, win, shift, x_dtype):
    rng = np.random.default_rng(b * h * w * c + shift)
    x, g, bln, wqkv, bqkv = _window_attn_inputs(rng, b, h, w, c, 1, win, x_dtype, cuda)[:5]
    wqkv = wqkv.bfloat16()
    kw = dict(window=win, shift=shift)
    before = window_attn_qkv.launches
    got = window_attn_qkv(x, g, bln, wqkv, bqkv, dtype=torch.bfloat16, **kw)
    again = window_attn_qkv(x, g, bln, wqkv, bqkv, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert window_attn_qkv.launches == before + 2
    ref = window_attn_qkv_plain(x.float(), g, bln, wqkv.float(), bqkv, dtype=torch.float32, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.equal(got, again)
    _bf16_close(got, ref)


@pytest.mark.parametrize("b,h,w,c,win,shift", [
    (2, 14, 21, 96, 7, 3),  # K = N = 96, shifted
    (1, 10, 13, 96, 7, 3),  # shift 3: the scatter drops the padding rows
    (4, 5, 8, 96, 5, 0),  # the shrunk window of 5
    (1, 20, 30, 256, 7, 3),
    (1, 36, 64, 1280, 14, 0),  # ViT-H's rect grid
])
def test_bf16_proj_gemm_matches_plain(cuda, b, h, w, c, win, shift):
    rng = np.random.default_rng(b * h * w * c + win + shift)
    hp, wp = -(-h // win) * win, -(-w // win) * win
    o = torch.from_numpy(rng.standard_normal((b * hp * wp, c)).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    wproj = torch.from_numpy((rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    bproj = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    kw = dict(out_shape=(b, h, w, c), window=win, shift=shift)
    got = window_attn_proj(o, wproj, bproj, heads=1, dtype=torch.bfloat16, **kw)
    again = window_attn_proj(o, wproj, bproj, heads=1, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    ref = window_attn_proj_plain(o.float(), wproj.float(), bproj, dtype=torch.float32, **kw)
    assert got.shape == (b, h, w, c) and torch.equal(got, again)
    _bf16_close(got, ref)


def test_bf16_block_through_autograd_on_card(cuda):
    """One bf16 Swin block through window_attn's autograd.Function: the
    forward (the two launches) agrees with the plain branch and gives equal
    bits twice; the gradients are the plain branch's."""
    rng = np.random.default_rng(7)
    args = _window_attn_inputs(rng, 2, 10, 13, 96, 3, 7, torch.float32, cuda)
    kw = dict(heads=3, window=7, shift=3, dtype=torch.bfloat16)
    outs, grads = [], []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in args]
        out = window_attn(*leaves, **kw)
        out.float().sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    ref_in = [t.clone().requires_grad_() for t in args]
    ref = window_attn_plain(*ref_in, **kw)
    ref.float().sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    full = window_attn_plain(*(t.float() for t in args[:3]), args[3].bfloat16().float(), args[4],
                             args[5].bfloat16().float(), *args[6:], heads=3, window=7, shift=3,
                             dtype=torch.float32)
    _bf16_close(outs[0], full)
    for g, r in zip(grads[0], ref_in):
        torch.testing.assert_close(g, r.grad, rtol=0, atol=0)


def test_bf16_wrappers_reject_what_tma_cannot_read(cuda):
    rng = np.random.default_rng(0)
    args = _window_attn_inputs(rng, 1, 8, 8, 20, 2, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="% 8"):
        window_attn(*args, heads=2, window=4, shift=0, dtype=torch.bfloat16)
    args = _window_attn_inputs(rng, 1, 8, 8, 16, 2, 4, torch.float32, cuda)
    x = torch.empty(8 * 8 * 16 + 1, device=cuda)[1:].view(1, 8, 8, 16).copy_(args[0])  # 4 B off
    with pytest.raises(ValueError, match="aligned"):
        window_attn(x, *args[1:], heads=2, window=4, shift=0, dtype=torch.bfloat16)


def _relpos_inputs(rng, b, h, w, c, heads, win, x_dtype, device):
    args = _window_attn_inputs(rng, b, h, w, c, heads, win, x_dtype, device)[:7]
    tables = tuple(torch.from_numpy(
        (0.3 * rng.standard_normal((2 * win - 1, c // heads))).astype(np.float32)).to(device)
        for _ in range(2))
    return args + tables


@pytest.mark.parametrize("b,h,w,c,heads,win,x_dtype,dtype", [
    (2, 8, 8, 32, 2, 4, torch.float32, torch.float32),  # no padding
    (2, 4, 4, 32, 2, 3, torch.float32, torch.float32),  # SAM_TEST's padded 4x4 grid
    (1, 10, 17, 40, 2, 7, torch.float32, torch.float32),  # padding both ways, head dim 20
    (1, 20, 30, 160, 2, 14, torch.float32, torch.float32),  # 196 tokens, head dim 80
    (2, 4, 4, 32, 2, 3, torch.float32, torch.bfloat16),
    (1, 10, 17, 40, 2, 7, torch.float32, torch.bfloat16),  # head dim 20 pads to 32
    (1, 20, 30, 128, 2, 14, torch.bfloat16, torch.bfloat16),  # ViT-L / B head dim 64
    (1, 36, 64, 1280, 16, 14, torch.float32, torch.bfloat16),  # ViT-H rect grid
    (1, 64, 64, 1280, 16, 14, torch.bfloat16, torch.bfloat16),  # ViT-H square grid
    # key counts that the 64-key chunk does not divide: 81 tokens (96
    # padded: a 32-key chunk), 144 (a 16-key chunk) at head dim 48
    (1, 20, 20, 64, 2, 9, torch.bfloat16, torch.bfloat16),
    (1, 24, 30, 96, 2, 12, torch.bfloat16, torch.bfloat16),
    (1, 15, 22, 80, 2, 5, torch.bfloat16, torch.bfloat16),  # head dim 40 pads to 48
])
def test_window_attn_relpos_kernel_matches_plain(cuda, b, h, w, c, heads, win, x_dtype, dtype):
    rng = np.random.default_rng(b * h * w * c + win)
    args = _relpos_inputs(rng, b, h, w, c, heads, win, x_dtype, cuda)
    kw = dict(heads=heads, window=win, dtype=dtype)
    before = (window_attn_relpos_heads.launches, window_attn_relpos_proj.launches,
              window_attn_proj.launches)
    got = window_attn_relpos(*args, **kw)
    got_o = window_attn_relpos_heads(*args[:5], *args[7:], **kw)
    torch.cuda.synchronize()
    assert (window_attn_relpos_heads.launches, window_attn_relpos_proj.launches,
            window_attn_proj.launches) == (before[0] + 2, before[1] + 1, before[2])
    want = window_attn_relpos_plain(*args, **kw)
    want_o = window_attn_relpos_heads_plain(*args[:5], *args[7:], **kw)
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    for g, ref in ((got_o, want_o), (got, want)):
        err = float((g.float() - ref.float()).abs().max())
        assert err <= tol * float(ref.float().abs().max()), (err, tol)


def test_window_attn_relpos_wrapper_rejects_bad_input(cuda):
    rng = np.random.default_rng(0)
    args = _relpos_inputs(rng, 1, 8, 8, 32, 2, 4, torch.float32, cuda)
    kw = dict(heads=2, window=4)
    with pytest.raises(TypeError, match="f32 x"):  # bf16 x under f32 compute
        window_attn_relpos(args[0].bfloat16(), *args[1:], dtype=torch.float32, **kw)
    with pytest.raises(TypeError, match="compute dtype"):
        window_attn_relpos(*args, dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        window_attn_relpos(args[0].transpose(1, 2), *args[1:], dtype=torch.float32, **kw)
    # caps: the message names the entry that serves the other model
    big = _relpos_inputs(rng, 1, 16, 16, 32, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="window_attn_relpos"):
        window_attn_relpos(*big, heads=2, window=16, dtype=torch.float32)
    swin = _window_attn_inputs(rng, 1, 14, 14, 32, 2, 14, torch.float32, cuda)
    with pytest.raises(ValueError, match="window_attn_relpos"):
        window_attn(*swin, heads=2, window=14, shift=0, dtype=torch.float32)


def test_fused_sam_encoder_card_matches_cpu(cuda, monkeypatch):
    """SAM_TEST with window 3 (a 4x4 grid padded to 6x6): the fused encoder
    on the card (f32, TF32 off) within 1e-4 of the CPU's largest magnitude,
    one launch of each kernel per windowed block."""
    import dataclasses

    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.sam import SAM_TEST, Sam

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(SAM_TEST, window_size=3, fused_window_attn=True)
    model = init_weights(Sam(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32))
    before = (window_attn_relpos_heads.launches, window_attn_relpos_proj.launches)
    with torch.no_grad():
        want = model.encode_image(x)
        got = model.to(cuda).encode_image(x.to(cuda))
    n_windowed = cfg.encoder_depth - len(cfg.encoder_global_attn)
    assert (window_attn_relpos_heads.launches, window_attn_relpos_proj.launches) == (
        before[0] + n_windowed, before[1] + n_windowed)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_swin_shrunk_window_card_matches_cpu(cuda, monkeypatch):
    """SWIN_TEST on a 24x40 input: stage 1 is 3x5, so its window shrinks
    from 4 to 3 and the kernels read the centre of the bias table. f32 with
    TF32 off; the card within 1e-4 of the CPU's largest magnitude."""
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.swin import SWIN_TEST, SwinTransformer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = init_weights(SwinTransformer(SWIN_TEST), torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 24, 40, 3)).astype(np.float32))
    before = window_attn_heads.launches
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda))
    assert window_attn_heads.launches == before + sum(SWIN_TEST.depths)
    assert tuple(want["swin1"].shape[1:3]) == (3, 5)
    for k in want:
        err = float((got[k].cpu() - want[k]).abs().max())
        assert err <= 1e-4 * float(want[k].abs().max()), (k, err)


def _mini_nuscenes(root, n_frames=2, seed=0):
    """The tables the mask stage reads (the rest empty), plus one JPEG per
    camera and frame."""
    from PIL import Image

    from cm3d_tpu_torch.datasets.nuscenes.tables import CAM_LIST

    rng = np.random.default_rng(seed)
    version = root / "v1.0-mini"
    version.mkdir(parents=True)
    samples, sample_data = [], []
    for f in range(n_frames):
        data = {}
        for cam in CAM_LIST:
            name = f"samples/{cam}/{f}.jpg"
            (root / name).parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray((rng.random((90, 160, 3)) * 255).astype(np.uint8)).save(root / name)
            data[cam] = f"sd-{cam}-{f}"
            sample_data.append({"token": data[cam], "filename": name})
        samples.append({"token": f"s{f}", "next": f"s{f + 1}" if f + 1 < n_frames else "",
                        "data": data})
    tables = {"scene": [{"token": "sc", "name": "scene-0001", "first_sample_token": "s0",
                         "log_token": "l"}],
              "sample": samples, "sample_data": sample_data, "log": [],
              "calibrated_sensor": [], "ego_pose": [], "attribute": []}
    for name, rows in tables.items():
        (version / f"{name}.json").write_text(json.dumps(rows))


def test_masks_cli_cuda_matches_cpu(cuda, tmp_path, capsys):
    """The masks CLI on the card (Detic through the window-attention
    kernels, f32 with TF32 off) writes the CPU run's labels and cameras, and
    masks that differ in at most 1e-3 of their pixels (bits whose logit
    lies near 0 may flip)."""
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.pipelines import masks

    _mini_nuscenes(tmp_path / "nusc")
    outs = {}
    for device in ("cpu", "cuda"):
        out = tmp_path / device
        argv = ["--dataroot", str(tmp_path / "nusc"), "--out_dir", str(out),
                "--fake_weights", "--thumbnail", "96", "--device", device]
        before = window_attn_heads.launches
        masks.main(argv)
        assert (window_attn_heads.launches > before) == (device == "cuda")
        assert "2 frames done" in capsys.readouterr().out
        masks.main(argv)  # resumed: nothing re-processed
        assert "frames/sec" not in capsys.readouterr().out
        outs[device] = MaskArtifactStore(out)
        assert outs[device].remaining_scenes(["scene-0001"]) == []
    n_masks = 0
    for f in range(2):
        want, got = outs["cpu"].read_frame("scene-0001", f), outs["cuda"].read_frame(
            "scene-0001", f)
        assert got.labels == want.labels and got.cam_nums == want.cam_nums
        if want.labels:
            assert (got.masks != want.masks).mean() <= 1e-3
        n_masks += len(want.labels)
    assert n_masks > 0


def test_e2e_cli_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The fused images -> boxes CLI on the card (Detic and SAM through the
    window-attention kernels, the lift through compaction and medoid; f32
    with TF32 off) writes the CPU run's submission: the same samples, names
    and counts, centres within 1e-3 m, scores within 1e-4. The dataroot is
    the port's nuScenes fixture (tests/torch_nusc_fixture.py, no JAX)."""
    from torch_nusc_fixture import VERSION, make_fake_nuscenes

    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.kernels.window_attn_relpos import window_attn_relpos_heads
    from cm3d_tpu_torch.pipelines import e2e
    from cm3d_tpu_torch.pipelines import masks as masks_mod

    root = tmp_path / "nusc"
    info = make_fake_nuscenes(root, tmp_path / "planted", n_frames=3, n_objects=6)
    small = LiftStageConfig(max_points=16384, max_masks=32, max_points_per_mask=512,
                            max_points_per_camera=8192, max_points_in_masks=2048,
                            max_lane_points=1024)
    real_run, real_build = e2e.run_e2e, masks_mod.build_fake_models

    def small_run_e2e(*a, **kw):  # the CLI's production caps, cut to the fixture's size
        import dataclasses

        kw.update(lift_cfg=small, batch_size=2, mask_cfg=dataclasses.replace(
            kw["mask_cfg"], max_detections=16, max_masks_total=32, dtype="float32"))
        return real_run(*a, **kw)

    monkeypatch.setattr(e2e, "run_e2e", small_run_e2e)
    # the CLI has no flag for the fused blocks (the JAX CLIs have none): switch
    # them on under it, so the card run goes through every kernel of the port
    monkeypatch.setattr(masks_mod, "build_fake_models",
                        lambda **kw: real_build(fused_window_attn=True, **kw))
    subs = {}
    for device in ("cpu", "cuda"):
        out = tmp_path / f"{device}.json"
        counts = (compact_rows.launches, medoid_distance_sums_rows.launches,
                  window_attn_heads.launches, window_attn_relpos_heads.launches)
        e2e.main(["--dataroot", str(root), "--version", VERSION, "--scenes",
                  info["scene_name"], "--out", str(out), "--fake_weights", "--thumbnail", "160",
                  "--device", device])
        after = (compact_rows.launches, medoid_distance_sums_rows.launches,
                 window_attn_heads.launches, window_attn_relpos_heads.launches)
        assert all((a > b) == (device == "cuda") for a, b in zip(after, counts))
        subs[device] = json.loads(out.read_text())
    want, got = subs["cpu"], subs["cuda"]
    assert set(got["results"]) == set(want["results"])
    n_boxes = 0
    for tok, boxes in want["results"].items():
        assert len(got["results"][tok]) == len(boxes)
        for g, w in zip(got["results"][tok], boxes):
            assert g["detection_name"] == w["detection_name"]
            np.testing.assert_allclose(g["translation"], w["translation"], rtol=0, atol=1e-3)
            np.testing.assert_allclose(g["detection_score"], w["detection_score"], rtol=0,
                                       atol=1e-4)
        n_boxes += len(boxes)
    assert n_boxes > 0


def test_kitti_clis_run_on_the_card_by_default(cuda, tmp_path, monkeypatch, capsys):
    """The KITTI CLIs without --device run on the card (the kernels' launch
    counts move) and write the CPU run's results (--device cpu): the masks
    CLI the same labels, masks differing in at most 1e-3 of their pixels;
    lift_kitti and the fused e2e CLI the same objects, box centres within
    1e-3 m and scores within 1e-4 (medoids agree but for near ties, which
    these seeded frames do not hold)."""
    import dataclasses

    from kitti_fixture import make_kitti_root

    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.kitti.calib import read_label
    from cm3d_tpu_torch.pipelines import e2e, lift_kitti, masks

    root = make_kitti_root(tmp_path / "kitti", tmp_path / "planted", n_frames=2)
    # the CLIs' production caps, cut to the fixture's size
    small = LiftStageConfig(num_sweeps=1, image_ratio=0.8366, sqrt_min_dist_load_filter=False,
                            max_points=8192, max_masks=16, max_points_per_mask=512,
                            max_points_per_camera=4096, max_points_in_masks=2048,
                            max_lane_points=64)
    monkeypatch.setattr(lift_kitti, "KITTI_LIFT", small)
    real_run = e2e.run_e2e_kitti

    def small_run(*a, **kw):
        kw.update(lift_cfg=small, batch_size=2, mask_cfg=dataclasses.replace(
            kw["mask_cfg"], max_detections=8, max_masks_total=16, dtype="float32"))
        return real_run(*a, **kw)

    monkeypatch.setattr(e2e, "run_e2e_kitti", small_run)
    labels = {}
    for device in ("cpu", "cuda"):
        flag = ["--device", "cpu"] if device == "cpu" else []
        before = (compact_rows.launches, window_attn_heads.launches)
        masks.main(["--dataset", "kitti", "--dataroot", str(root), "--out_dir",
                    str(tmp_path / f"masks_{device}"), "--scenes", "0,1", "--fake_weights",
                    "--thumbnail", "128"] + flag)
        lift_kitti.main(["--root", str(root), "--mask_dir", str(tmp_path / "planted"),
                         "--out_dir", str(tmp_path / f"lift_{device}")] + flag)
        e2e.main(["--dataset", "kitti", "--dataroot", str(root), "--scenes", "0,1", "--out",
                  str(tmp_path / f"e2e_{device}"), "--fake_weights", "--thumbnail", "512"] + flag)
        after = (compact_rows.launches, window_attn_heads.launches)
        assert all((a > b) == (device == "cuda") for a, b in zip(after, before))
        labels[device] = {kind: [read_label(tmp_path / f"{kind}_{device}" / "pred" / f"{i:06d}.txt")
                                 for i in range(2)] for kind in ("lift", "e2e")}
    capsys.readouterr()
    for f in range(2):
        want = MaskArtifactStore(tmp_path / "masks_cpu").read_frame("kitti", f)
        got = MaskArtifactStore(tmp_path / "masks_cuda").read_frame("kitti", f)
        assert got.labels == want.labels
        if want.labels:
            assert (got.masks != want.masks).mean() <= 1e-3
    n_objects = 0
    for kind in ("lift", "e2e"):
        for got, want in zip(labels["cuda"][kind], labels["cpu"][kind]):
            assert [o.type for o in got] == [o.type for o in want]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.t, w.t, rtol=0, atol=1e-3)
                assert abs(g.score - w.score) <= 1e-4
            n_objects += len(want)
    assert n_objects > 0


def _segment_inputs(seed, r, n, d, n_cells, device):
    rng = np.random.default_rng(seed)
    used = rng.permutation(n_cells)[: max(1, 2 * n_cells // 3)]  # the rest stay empty
    cell = rng.choice(used, (r, n)).astype(np.int32)
    cell[rng.random((r, n)) < 0.2] = n_cells + 1  # the sink
    if r > 1 and n <= 5000:
        cell[1] = used[0]  # one run as long as the row
    cell.sort(axis=1)
    values = rng.normal(size=(r, d, n)).astype(np.float32)
    maxvals = rng.normal(size=(r, n)).astype(np.float32)
    values[np.broadcast_to((cell >= n_cells)[:, None], values.shape)] = 0.0
    maxvals[cell >= n_cells] = -np.inf
    return tuple(torch.from_numpy(a).to(device) for a in (cell, values, maxvals))


@pytest.mark.parametrize("r,n,d,n_cells", [
    (1, 64, 1, 7),
    (3, 1000, 5, 129),  # pillarize's channel count
    (2, 257, 32, 600),  # the splat's channel count, cells > elements
    (8, 32768, 5, 16385),  # batch-8 pillarize
    (2, 82944, 32, 16385),  # two samples of the camera splat
    (4, 5000, 19, 1),  # one cell, a ragged channel chunk
])
def test_segment_kernels_match_plain(cuda, r, n, d, n_cells):
    cell, values, maxvals = _segment_inputs(r * n + d, r, n, d, n_cells, cuda)
    _check_segment_kernels(cuda, cell, values, maxvals, n_cells)


def _check_segment_kernels(cuda, cell, values, maxvals, n_cells):
    """Both forward variants and the backward against the plain versions,
    one counted launch a call, the same bits on a second call."""
    r, d, n = values.shape
    before = (segment_sum_max.launches, segment_sum.launches, segment_sum_bwd.launches)
    sums, maxs = segment_sum_max(cell, values, maxvals, n_cells)
    only = segment_sum(cell, values, n_cells)
    torch.cuda.synchronize()
    assert (segment_sum_max.launches, segment_sum.launches) == (before[0] + 1, before[1] + 1)
    want_s, want_m = segment_sum_max_plain(cell, values, maxvals, n_cells)
    # against the sums taken in f64: an f32 sum of k terms in any order is
    # within k * 2^-24 * sum|v| of it (1e-5 of the sum for the short runs of
    # real data; the fixtures also hold runs as long as their row)
    exact = segment_sum_plain(cell, values.double(), n_cells)
    mass = segment_sum_plain(cell, values.abs().double(), n_cells)
    count = segment_sum_plain(cell, torch.ones_like(values[:, :1]).double(), n_cells)
    bound = 1e-6 + count * 2.0 ** -24 * mass
    assert bool(((sums.double() - exact).abs() <= bound).all())
    assert bool(((want_s.double() - exact).abs() <= bound).all())
    assert torch.equal(maxs, want_m)
    assert torch.equal(only, sums)  # the two variants add in the same order
    empty = torch.ones((r, n_cells), dtype=torch.bool, device=cuda)
    rows = torch.arange(r, device=cuda)[:, None].expand_as(cell)
    real = cell < n_cells
    empty[rows[real], cell[real].long()] = False
    assert bool((maxs[empty] == float("-inf")).all())
    assert bool((sums.transpose(1, 2)[empty] == 0).all())
    # replay: the same bits twice
    again_s, again_m = segment_sum_max(cell, values, maxvals, n_cells)
    assert torch.equal(again_s, sums) and torch.equal(again_m, maxs)
    assert torch.equal(segment_sum(cell, values, n_cells), only)
    # the backward is the gather, equal to autograd through the plain scatter
    ct = torch.randn(sums.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    a = values.clone().requires_grad_()
    b = values.clone().requires_grad_()
    (segment_sum(cell, a, n_cells) * ct).sum().backward()
    (segment_sum_plain(cell, b, n_cells) * ct).sum().backward()
    torch.cuda.synchronize()
    assert segment_sum_bwd.launches == before[2] + 1
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(segment_sum_bwd(cell, ct), segment_sum_bwd_plain(cell, ct))
    return sums, maxs


SEGMENT_CELLS, SEGMENT_SERIAL, SEGMENT_IDS_CAP = 256, 16, 4096  # csrc/segment.cu's block


def _runs_row(runs, n, sink):
    """One row of sorted ids from (id, length) runs, padded with `sink`."""
    row = np.concatenate([np.full(length, c, np.int32) for c, length in runs] or
                         [np.zeros(0, np.int32)])
    assert len(row) <= n and np.all(np.diff(row) >= 0)
    return np.concatenate([row, np.full(n - len(row), sink, np.int32)])


@pytest.mark.parametrize("n", [9000, 9001])
@pytest.mark.parametrize("d", [5, 32])  # pillarize's channels, the splat's
def test_segment_kernels_at_block_edges(cuda, n, d):
    """Rows laid out against the forward's blocks, n_cells = h*w with the
    callers' sink id h*w: runs of a thread's longest and a warp's shortest
    length, runs either side of a 256-cell block's edge, a run as long as
    the row, a block whose cells hold more ids than it stages in shared
    memory, a row of sink ids only, one with none, one whose last cells
    stay empty."""
    h = w = 24
    n_cells, sink = h * w, h * w
    t, cap = SEGMENT_SERIAL, SEGMENT_IDS_CAP
    b = SEGMENT_CELLS
    edges = [(0, 3), (2, 1), (5, t), (6, t + 1), (10, 2), (b - 2, 5), (b - 1, t), (b, t + 1),
             (b + 1, 1), (300, 300), (2 * b - 1, 4), (2 * b, 2 * t + 1), (n_cells - 1, 2)]
    rows = [
        _runs_row(edges, n, sink),
        _runs_row([(0, n)], n, sink),  # one run as long as the row, of cell 0
        _runs_row([], n, sink),  # the sink only
        _runs_row([(c, n // n_cells + (c < n % n_cells)) for c in range(n_cells)], n, sink),
        _runs_row([(c, 40) for c in range(5, 100)], n, sink),  # cells 100.. stay empty
        _runs_row([(c, 20) for c in range(b, 2 * b)], n, sink),  # 5120 ids in one block
    ]
    assert 20 * b > cap
    cell = torch.from_numpy(np.stack(rows)).to(cuda)
    assert int((cell[3] < n_cells).sum()) == n  # the row without a sink id
    rng = np.random.default_rng(n + d)
    values = torch.from_numpy(rng.normal(size=(len(rows), d, n)).astype(np.float32)).to(cuda)
    maxvals = torch.from_numpy(rng.normal(size=(len(rows), n)).astype(np.float32)).to(cuda)
    sums, maxs = _check_segment_kernels(cuda, cell, values, maxvals, n_cells)
    assert bool((sums[2] == 0).all()) and bool((maxs[2] == float("-inf")).all())
    assert bool((maxs[4, 100:] == float("-inf")).all()) and bool((maxs[4, 5:100] > -1e30).all())


def test_segment_wrappers_reject_bad_input_on_card(cuda):
    cell = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    values = torch.zeros((2, 3, 8), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        segment_sum(cell.long(), values, 4)
    with pytest.raises(TypeError, match="float32"):
        segment_sum_max(cell, values.half(), values[:, 0], 4)
    with pytest.raises(ValueError, match="different devices"):
        segment_sum(cell, values.cpu(), 4)
    # degenerate sizes never reach the kernel and still fill every output
    sums, maxs = segment_sum_max(cell[:, :0], values[:, :, :0], values[:, 0, :0], 4)
    assert bool((sums == 0).all()) and bool((maxs == float("-inf")).all())


@pytest.mark.parametrize("b,h,w,c,heads,win,shift,dtype", [
    (2, 12, 16, 96, 3, 7, 0, torch.float32),  # Swin-T stage 0 widths
    (2, 12, 16, 96, 3, 7, 3, torch.float32),
    (2, 9, 16, 384, 12, 7, 3, torch.bfloat16),  # stage 2, bf16 compute
    (3, 5, 8, 768, 24, 5, 0, torch.float32),  # stage 3: the window shrunk to 5
])
def test_window_attn_gradients_on_card(cuda, b, h, w, c, heads, win, shift, dtype):
    """A loss through `window_attn` on the card reaches x and every
    parameter, with the plain branch's gradients."""
    gen = torch.Generator(cuda).manual_seed(b * c + shift)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=cuda, generator=gen) * scale

    args = [rnd(b, h, w, c), 1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
            rnd(3 * c, c, scale=c ** -0.5), rnd(3 * c, scale=0.1), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1), rnd((2 * win - 1) ** 2, heads, scale=0.5)]
    kw = dict(heads=heads, window=win, shift=shift, dtype=dtype)
    got_in = [t.clone().requires_grad_() for t in args]
    ref_in = [t.clone().requires_grad_() for t in args]
    before = window_attn_heads.launches
    out = window_attn(*got_in, **kw)
    assert window_attn_heads.launches == before + 1
    ref = window_attn_plain(*ref_in, **kw)
    ct = torch.randn(out.shape, device=cuda, generator=gen).to(out.dtype)
    out.backward(ct)
    ref.backward(ct)
    torch.cuda.synchronize()
    tol = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-4
    err = float((out.detach().float() - ref.detach().float()).abs().max())
    assert err <= tol * float(ref.detach().abs().max())
    for name, g, r in zip(("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "table"),
                          got_in, ref_in):
        assert g.grad is not None and float(g.grad.abs().sum()) > 0, name
        torch.testing.assert_close(g.grad, r.grad, rtol=0, atol=0, msg=name)
    # no graph without grad: the inference path is the two launches alone
    with torch.no_grad():
        assert not window_attn(*got_in, **kw).requires_grad


def test_window_attn_relpos_refuses_a_graph_on_card(cuda):
    c, heads, win = 32, 2, 4
    x = torch.randn(1, 8, 8, c, device=cuda)
    params = [torch.ones(c, device=cuda), torch.zeros(c, device=cuda),
              torch.randn(3 * c, c, device=cuda) * 0.1, torch.zeros(3 * c, device=cuda),
              torch.randn(c, c, device=cuda) * 0.1, torch.zeros(c, device=cuda),
              torch.randn(2 * win - 1, c // heads, device=cuda),
              torch.randn(2 * win - 1, c // heads, device=cuda)]
    kw = dict(heads=heads, window=win, dtype=torch.float32)
    window_attn_relpos(x, *params, **kw)  # no grad needed: runs
    with pytest.raises(NotImplementedError, match="no backward on the card"):
        window_attn_relpos(x.requires_grad_(), *params, **kw)
    with torch.no_grad():
        window_attn_relpos(x, *params, **kw)


def test_pillarize_and_splat_on_card_match_cpu(cuda):
    """The two callers of the segment kernels, card against CPU on the same
    numpy inputs: pillar features and the pooled camera map within rtol /
    atol 1e-5 (f32 sums in another order; the geometry bins identically in
    full f32), the splat's gradients within 1e-6 (gathers times the other
    factor)."""
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig, splat_to_bev
    from cm3d_tpu_torch.train.voxelize import PillarConfig, pillarize
    from cm3d_tpu_torch.utils.device import strict_f32

    strict_f32()
    rng = np.random.default_rng(0)
    pcfg = PillarConfig(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, resolution=1.0,
                        z_min=-3.0, z_max=3.0)
    pts = torch.from_numpy(rng.uniform([-9, -9, -4, 0], [9, 9, 4, 1], (3, 5000, 4))
                           .astype(np.float32))
    valid = torch.from_numpy(rng.random((3, 5000)) < 0.9)
    before = (segment_sum_max.launches, segment_sum.launches, segment_sum_bwd.launches)
    got = pillarize(pts.to(cuda), valid.to(cuda), pcfg)
    torch.testing.assert_close(got.cpu(), pillarize(pts, valid, pcfg), rtol=1e-5, atol=1e-5)

    cfg = BevFusionConfig(cam_channels=4, cam_trunk=(4, 8), depth_bins=4, d_min=1.0, d_max=7.0)
    feats = torch.from_numpy(rng.normal(size=(2, 2, 6, 8, 4)).astype(np.float32))
    depth = torch.softmax(torch.from_numpy(rng.normal(size=(2, 2, 6, 8, 4)).astype(np.float32)),
                          dim=-1)
    intr = torch.tensor([[12.0, 0, 16.0], [0, 12.0, 12.0], [0, 0, 1]]).tile(2, 2, 1, 1)
    e0 = torch.tensor([[0, 0, 1, 0.5], [-1, 0, 0, 0.0], [0, -1, 0, 0.2], [0, 0, 0, 1.0]])
    e1 = torch.tensor([[-1, 0, 0, 0.0], [0, 0, -1, -0.5], [0, -1, 0, 0.2], [0, 0, 0, 1.0]])
    ext = torch.stack([e0, e1]).tile(2, 1, 1, 1)
    ct = torch.from_numpy(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    results = []
    for device in (torch.device("cpu"), cuda):
        f, d = (t.clone().to(device).requires_grad_() for t in (feats, depth))  # leaves
        bev = splat_to_bev(f, d, intr.to(device), ext.to(device), pcfg, cfg)
        (bev * ct.to(device)).sum().backward()
        results.append((bev.detach().cpu(), f.grad.cpu(), d.grad.cpu()))
    assert float(results[0][0].abs().sum()) > 0
    torch.testing.assert_close(results[1][0], results[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(results[1][1], results[0][1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(results[1][2], results[0][2], rtol=1e-5, atol=1e-6)
    assert (segment_sum_max.launches, segment_sum.launches, segment_sum_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


@pytest.mark.parametrize("with_pose", [False, True])
def test_range_image_on_card_matches_cpu(cuda, with_pose):
    """The Waymo range-image unprojection at the TOP lidar's 64 x 2650 on the
    card against the CPU: validity equal, points within 2e-3 m (f32 through
    the global frame, around 3000 m, where TF32 would cost metres; the op
    has no matmul, so no backend flag can switch it to TF32)."""
    from cm3d_tpu_torch.ops.range_image import pixel_pose_matrices, range_image_to_points

    rng = np.random.default_rng(0)
    h, w = 64, 2650
    ri = rng.uniform(2, 75, (h, w)).astype(np.float32)
    ri[rng.random((h, w)) < 0.1] = -1.0
    incl = np.linspace(0.04, -0.3, h).astype(np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [1.4, 0.0, 2.2]
    pose6 = np.zeros((h, w, 6), np.float32)
    pose6[..., 2] = 0.7
    pose6[..., 3:6] = [3000.0, -1200.0, 30.0]
    pose6[..., 3] += np.linspace(-1, 1, w, dtype=np.float32)[None]
    frame = np.eye(4)
    frame[:2, :2] = [[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]]
    frame[:3, 3] = [3000.0, -1200.0, 30.0]
    inv = np.linalg.inv(frame).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = True  # must not matter
    try:
        out = []
        for device in (torch.device("cpu"), cuda):
            kw = {}
            if with_pose:
                kw = dict(pixel_pose=pixel_pose_matrices(torch.from_numpy(pose6).to(device)),
                          frame_pose_inv=torch.from_numpy(inv).to(device))
            pts, valid = range_image_to_points(torch.from_numpy(ri).to(device),
                                               torch.from_numpy(incl).to(device),
                                               torch.from_numpy(ext).to(device), **kw)
            out.append((pts.cpu(), valid.cpu()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(out[0][1], out[1][1]) and 0 < int(out[0][1].sum()) < h * w
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=2e-3)


def test_released_checkpoints_load_at_full_size_on_card(cuda, tmp_path):
    """build_real_models on the card from full-size released files (Detic
    Swin-B with fc1 in detectron2's (c, y, x) order, SAM ViT-H, CLIP B/32
    under Detic's prefix; seeded random weights): every key read, the
    classifier [512, 19] of unit columns, one Detic forward's boxes
    finite."""
    import dataclasses
    import gzip

    from cm3d_tpu_torch.models.clip_text import CLIP_TEXT_B32, ClipTextEncoder, init_clip_weights
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.detic import DETIC_SWINB, Detic
    from cm3d_tpu_torch.models.sam import SAM_VIT_H, Sam
    from cm3d_tpu_torch.pipelines import masks

    gen = torch.Generator(device=cuda)
    with torch.device(cuda):
        detic = init_weights(Detic(DETIC_SWINB), gen.manual_seed(0))
        sam = init_weights(Sam(SAM_VIT_H), gen.manual_seed(1))
        clip = init_clip_weights(ClipTextEncoder(CLIP_TEXT_B32), gen.manual_seed(2))
    sd = {k: v.cpu() for k, v in detic.state_dict().items()}
    p, c = DETIC_SWINB.pooler_size, DETIC_SWINB.fpn_dim
    for k in range(DETIC_SWINB.num_cascade_stages):
        w = sd[f"roi_heads.box_head.{k}.fc1.weight"]
        sd[f"roi_heads.box_head.{k}.fc1.weight"] = (
            w.reshape(-1, p, p, c).permute(0, 3, 1, 2).reshape(w.shape))
    torch.save({"model": sd, "iteration": 1}, tmp_path / "detic.pth")
    torch.save({k: v.cpu() for k, v in sam.state_dict().items()}, tmp_path / "sam.pth")
    torch.save({f"text_encoder.{k}": v.cpu() for k, v in clip.state_dict().items()},
               tmp_path / "clip.pt")
    with gzip.open(tmp_path / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version: toy\nc a\nca r</w>")
    seen = {}
    real = masks._batched_model_fns

    def spy(detic_model, classifier, sam_model, vocabulary, **kw):
        seen.update(detic=detic_model, classifier=classifier)
        return real(detic_model, classifier, sam_model, vocabulary, **kw)

    masks._batched_model_fns = spy
    try:
        models = masks.build_real_models(str(tmp_path / "detic.pth"), str(tmp_path / "sam.pth"),
                                         str(tmp_path / "clip.pt"), str(tmp_path / "bpe.txt.gz"),
                                         device=cuda)
    finally:
        masks._batched_model_fns = real
    assert seen["classifier"].shape == (512, 19)
    np.testing.assert_allclose(np.linalg.norm(seen["classifier"], axis=0), 1.0, atol=1e-5)
    got = seen["detic"].state_dict()
    torch.testing.assert_close(got["roi_heads.box_head.0.fc1.weight"].float().cpu(),
                               detic.state_dict()["roi_heads.box_head.0.fc1.weight"].cpu()
                               .to(got["roi_heads.box_head.0.fc1.weight"].dtype).float())
    boxes = models.detic(models.prepare([np.full((576, 1024, 3), 100, np.uint8)] * 2))[0]
    assert bool(torch.isfinite(boxes).all())


# ---- the kernels as dispatcher ops, and through an exported program ------


@pytest.mark.parametrize("case", torch_op_cases.case_ids())
def test_opcheck_every_op_on_card(cuda, case):
    """torch.library.opcheck on CUDA tensors: the CUDA implementation (the
    launcher) against the op's schema, its fake implementation's shapes,
    dtypes and strides, and AOT dispatch with dynamic shapes."""
    op, dtype = torch_op_cases.CASES[torch_op_cases.case_ids().index(case)]
    overload, args = torch_op_cases.op_and_args(op, dtype, cuda)
    torch.library.opcheck(overload, args)
    torch.cuda.synchronize()


def _small_lift(cuda, batch):
    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device

    cfg = LiftStageConfig(num_sweeps=1, max_points=2048, max_masks=16, max_points_per_mask=256,
                          max_points_per_camera=1024, max_points_in_masks=512,
                          max_lane_points=64)
    rng = np.random.default_rng(0)
    syn = SyntheticConfig(points_per_frame=1500, objects_per_frame=6)
    host = stack_keyframes([make_keyframe(syn, cfg, rng) for _ in range(batch)])
    return cfg, to_device(host.frames, cuda)


def test_exported_lift_step_launches_through_the_ops(cuda, tmp_path):
    """The lift step exported on the card: tracing launches nothing; the
    saved and loaded program launches 3 compactions and 1 medoid a call,
    counted by the ops, and is bit-equal to the in-process step."""
    import torch.utils._pytree as pytree

    from cm3d_tpu_torch import deploy
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn

    cfg, frames = _small_lift(cuda, 2)

    def counts():
        return compact_rows.launches, medoid_distance_sums_rows.launches

    before = counts()
    program = deploy.export_lift_step(cfg, batch_size=2, device=cuda)
    assert counts() == before  # the fake implementations ran
    loaded = deploy.load_artifact(deploy.save_artifact(program, tmp_path / "lift.pt2"))
    assert loaded.platforms == ["cuda"]
    before = counts()
    got = loaded.call(frames)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 3, before[1] + 1)
    want = make_keyframe_step_fn(cfg, device=cuda)(frames)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    assert int(got[1].keep.sum()) > 0


def test_exported_detect_step_on_card(cuda, tmp_path):
    """The detect step exported on the card with its parameters as inputs:
    one segment_sum_max launch a call through the loaded program, equal to
    make_detect_fn on the same weights."""
    from cm3d_tpu_torch import deploy
    from cm3d_tpu_torch.config import class_arrays
    from cm3d_tpu_torch.pipelines.detect import make_detect_fn
    from cm3d_tpu_torch.train import PillarConfig
    from cm3d_tpu_torch.train.train import model_tensors

    torch.manual_seed(0)
    model = deploy.detect_model().to(cuda)
    before = segment_sum_max.launches
    program = deploy.export_detect_step(batch_size=2, max_points=4096, top_k=32,
                                        score_thresh=0.0, device=cuda)
    assert segment_sum_max.launches == before
    loaded = deploy.load_artifact(deploy.save_artifact(program, tmp_path / "d.pt2"))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-40, 40, (2, 4096, 4)).astype(np.float32)).to(cuda)
    valid = torch.ones((2, 4096), dtype=torch.bool, device=cuda)
    params, stats = model_tensors(model)
    got = loaded.call({k: v.detach() for k, v in params.items()}, stats, pts, valid)
    torch.cuda.synchronize()
    assert segment_sum_max.launches == before + 1
    _, _, radii = class_arrays()
    want = make_detect_fn(model, PillarConfig(), radii[:10], top_k=32, score_thresh=0.0)(
        pts, valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,k,n", [((4096, 1280), 1280, 3840), ((5, 64), 64, 24),
                                       ((2, 3, 50, 96), 96, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_ops_card_bit_equal_cpu(cuda, shape, k, n, dtype):
    """dynamic_int8_matmul / static_int8_matmul on the card give the CPU
    path's bits: the quantize and dequantize are the same IEEE steps, the
    int32 product is exact (cuBLASLt's int8 GEMM; 5 rows are padded to 17)."""
    from cm3d_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*shape[:-1], k, generator=gen).to(dtype)
    w_q, w_s = quant.quantize_weight(torch.randn(n, k, generator=gen))
    b = torch.randn(n, generator=gen)
    s = x.float().abs().max() / 127 * 0.8
    for got, want in (
            (quant.dynamic_int8_matmul(x.to(cuda), w_q.to(cuda), w_s.to(cuda), b.to(cuda)),
             quant.dynamic_int8_matmul(x, w_q, w_s, b)),
            (quant.static_int8_matmul(x.to(cuda), w_q.to(cuda), w_s.to(cuda), s.to(cuda)),
             quant.static_int8_matmul(x, w_q, w_s, s))):
        assert got.dtype == dtype and torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(torch.zeros(32, 12, dtype=torch.int8, device=cuda),
                     torch.zeros(8, 12, dtype=torch.int8, device=cuda))


@pytest.mark.parametrize("static", [False, True])
def test_sam_int8_encode_card_matches_cpu(cuda, monkeypatch, static):
    """SAM_TEST int8 (dynamic, or static calibrated on the CPU) on the card
    (f32, TF32 off) against the CPU: within one int8 step of the largest
    embedding value (an f32 summation-order difference may flip one int8
    rounding)."""
    import dataclasses

    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.sam import (
        SAM_TEST, Sam, calibrate_sam_act_scales, quantize_sam_state_dict)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(SAM_TEST, quant_int8=True, quant_static=static)
    sd = quantize_sam_state_dict(init_weights(Sam(SAM_TEST),
                                              torch.Generator().manual_seed(0)).state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    if static:
        sd = calibrate_sam_act_scales(cfg, sd, x[:1])
    model = Sam(cfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        want = model.eval().encode_image(x)
        got = model.to(cuda).encode_image(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= float(want.abs().max()) / 127


def test_zoedepth_card_matches_cpu(cuda):
    """ZOE_TEST on x10 synthetic weights (f32, TF32 off) on the card against
    the CPU: depth within rtol 1e-4 at 99.9% of the pixels and 5e-3 at all
    (chip_smoke.py's ZOE_RTOL / ZOE_RTOL_ALL: at the image border the
    head's p lies within 1e-3 of 1 and log(1 - p) carries the rounding of
    its last layer), predict_depth's flip average included."""
    from cm3d_tpu_torch.models.zoedepth import (
        ZOE_TEST, ZoeDepth, make_predict_depth, synth_zoedepth_state_dict,
        zoedepth_state_dict_from_released)
    from cm3d_tpu_torch.utils.device import strict_f32_scope

    sd = synth_zoedepth_state_dict(ZOE_TEST, np.random.default_rng(0))
    model = ZoeDepth(ZOE_TEST)
    model.load_state_dict(zoedepth_state_dict_from_released(
        {k: torch.from_numpy(v * 10) for k, v in sd.items()}, ZOE_TEST))
    img = np.random.default_rng(1).integers(0, 255, (90, 160, 3)).astype(np.uint8)
    want = make_predict_depth(model.eval())(img)
    with strict_f32_scope():
        got = make_predict_depth(model.to(cuda))(img)
    err = np.abs(got - want) / want
    assert np.mean(err <= 1e-4) >= 0.999 and err.max() <= 5e-3, err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 3])
def test_window_attn_kernel_at_gdino_stage0(cuda, shift, dtype):
    """GroundingDINO's Swin-T stage 0 on its 800 x 1216 canvas: a chunk of 3
    images at 200 x 304 (padded to 203 x 308, 62,524 tokens an image), C 96,
    3 heads of 32, f32 x."""
    rng = np.random.default_rng(shift)
    args = _window_attn_inputs(rng, 3, 200, 304, 96, 3, 7, torch.float32, cuda)
    kw = dict(heads=3, window=7, shift=shift, dtype=dtype)
    got = window_attn(*args, **kw)
    torch.cuda.synchronize()
    want = window_attn_plain(*args, **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    err = float((got.float() - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


def test_gdino_card_matches_cpu(cuda):
    """GDINO_TEST on synthetic released-layout weights (the fusion gammas
    redrawn from N(0, 0.5), as tests/test_torch_gdino.py), f32 with TF32
    off, on the card against the CPU: logits within 1e-4 of their largest
    |value|, boxes within 1e-5, the -inf pattern equal; the detector through
    attach_gdino launches each window-attention kernel once a Swin block a
    chunk (3 blocks, chunks of 3: 2 chunks for 5 images)."""
    from cm3d_tpu_torch.models.gdino import (
        GDINO_TEST, GroundingDino, gdino_state_dict_from_released, synth_gdino_state_dict)
    from cm3d_tpu_torch.pipelines.masks import MaskModels, attach_gdino
    from cm3d_tpu_torch.utils.device import strict_f32_scope

    rng = np.random.default_rng(0)
    sd = synth_gdino_state_dict(GDINO_TEST, rng)
    for k in sd:
        if k.endswith((".gamma_v", ".gamma_l")):
            sd[k] = (rng.standard_normal(sd[k].shape) * 0.5).astype(np.float32)
    sd = gdino_state_dict_from_released({k: torch.from_numpy(v) for k, v in sd.items()},
                                        GDINO_TEST)
    model = GroundingDino(GDINO_TEST)
    model.load_state_dict(sd)
    x = torch.from_numpy(rng.standard_normal((2, 64, 96, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, 60, (2, 24)))
    ids[:, 12:] = 0
    pos = torch.arange(24).repeat(2, 1)
    am = torch.ones((2, 24, 24), dtype=torch.bool)
    tm = ids != 0
    with torch.no_grad():
        want = model.eval()(x, ids, pos, am, tm)
        with strict_f32_scope():
            got = model.to(cuda)(*(t.to(cuda) for t in (x, ids, pos, am, tm)))
    fin = torch.isfinite(want[0])
    assert torch.equal(torch.isfinite(got[0]).cpu(), fin)
    err = float((got[0].cpu()[fin] - want[0][fin]).abs().max())
    assert err <= 1e-4 * float(want[0][fin].abs().max()), err
    assert float((got[1].cpu() - want[1]).abs().max()) <= 1e-5
    models = attach_gdino(MaskModels(None, None, None, None, vocabulary=("car", "tree")),
                          test=True, state_dict=sd, device=cuda)
    images = [rng.integers(0, 255, (48, 64, 3)).astype(np.uint8) for _ in range(5)]
    before = (window_attn_heads.launches, window_attn_proj.launches)
    with torch.no_grad():
        out = models.detic({"images": images})
    torch.cuda.synchronize()
    assert (window_attn_heads.launches - before[0], window_attn_proj.launches - before[1]) \
        == (6, 6)
    assert out[0].device.type == "cuda" and out[0].shape == (5, 12, 4)
