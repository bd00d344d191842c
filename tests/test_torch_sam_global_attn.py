"""SAM's global-attention kernel (kernels/sam_global_attn.py): the wrapper on
CPU tensors, and the kernel on the card.

On the CPU the wrapper runs the plain chain: it must equal, bit for bit, the
chain `models/sam.py Attention` ran in every block before the kernel (kept
below as `_old_chain`), so every JAX parity test still compares like with
like. On the card (tests marked `cuda`, skipped without a CUDA device; this
file imports neither JAX nor cm3d_tpu):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sam_global_attn.py

the kernel's largest error against a float64 computation of the same
function may be no larger than the plain chain's in bf16, where the chain
rounds the scores, both bias terms and the probabilities and the kernel
rounds only p and o. In f32 both sit at f32's rounding level, in other
summation orders, so the kernel may be up to twice the chain's error there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cm3d_tpu_torch.kernels import sam_global_attn as sga
from cm3d_tpu_torch.kernels.sam_global_attn import route, sam_global_attn
from cm3d_tpu_torch.ops import relpos_attn
from cm3d_tpu_torch.ops.relpos_attn import (
    add_decomposed_rel_pos_bnhc,
    get_rel_pos,
    relpos_attention,
    resize_rel_pos,
)


def _old_chain(q, k, v, rel_pos_h, rel_pos_w, dtype, q_hw, k_hw, row0):
    """`Attention.forward`'s attention before the kernel, as it was."""
    b, n = q.shape[:2]
    hd = q.shape[-1]
    attn = torch.einsum("bqhc,bkhc->bhqk", q * hd ** -0.5, k)
    attn = add_decomposed_rel_pos_bnhc(attn, q, rel_pos_h.to(dtype), rel_pos_w.to(dtype), q_hw,
                                       k_hw, q_rows=(row0, k_hw[0]))
    attn = torch.softmax(attn.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, n, -1)


def _inputs(b, qh, gw, kh, row0, heads, hd, dtype, table_rows_h=None, seed=0, device="cpu"):
    """q, k, v as a block has them (views of a qkv [b, n, 3, heads, hd];
    gathered, contiguous keys where the queries are a row slice), the f32
    parameter tables."""
    g = torch.Generator().manual_seed(seed)
    qkv = (1.5 * torch.randn(b, kh * gw, 3, heads, hd, generator=g)).to(device, dtype)
    q, k, v = qkv.unbind(2)
    if (qh, row0) != (kh, 0):
        q = q[:, row0 * gw:(row0 + qh) * gw]
        k, v = k.contiguous(), v.contiguous()
    rel_h = 0.5 * torch.randn(table_rows_h or 2 * kh - 1, hd, generator=g)
    rel_w = 0.5 * torch.randn(2 * gw - 1, hd, generator=g)
    return q, k, v, rel_h.to(device), rel_w.to(device)


CPU_CASES = [
    # b, qh, gw, kh, row0, heads, hd, dtype, h table rows
    (2, 4, 4, 4, 0, 2, 16, torch.float32, None),
    (1, 6, 5, 6, 0, 3, 8, torch.bfloat16, None),
    (1, 3, 8, 3, 0, 2, 16, torch.bfloat16, 15),  # a rect grid against a larger table
    (1, 2, 6, 6, 3, 2, 8, torch.float32, None),  # a sequence-sharded rank's rows
    (2, 2, 6, 6, 4, 2, 8, torch.bfloat16, 9),
]


@pytest.mark.parametrize("b,qh,gw,kh,row0,heads,hd,dtype,rows_h", CPU_CASES)
def test_cpu_wrapper_is_the_old_chain_bit_for_bit(b, qh, gw, kh, row0, heads, hd, dtype, rows_h):
    q, k, v, rel_h, rel_w = _inputs(b, qh, gw, kh, row0, heads, hd, dtype, rows_h)
    before = sam_global_attn.launches
    with torch.no_grad():
        got = sam_global_attn(q, k, v, rel_h.to(dtype), rel_w.to(dtype), q_hw=(qh, gw),
                              k_hw=(kh, gw), row0=row0)
    want = _old_chain(q, k, v, rel_h, rel_w, dtype, (qh, gw), (kh, gw), row0)
    assert got.dtype == dtype and got.shape == (b, qh * gw, heads * hd)
    assert torch.equal(got, want)
    assert sam_global_attn.launches == before  # the CPU launches nothing


def test_cpu_wrapper_under_autograd_is_the_plain_chain():
    q, k, v, rel_h, rel_w = _inputs(1, 4, 4, 4, 0, 2, 8, torch.float32)
    q = q.clone().requires_grad_()
    out = sam_global_attn(q, k, v, rel_h, rel_w, q_hw=(4, 4), k_hw=(4, 4))
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert torch.equal(out.detach(), _old_chain(q.detach(), k, v, rel_h, rel_w, torch.float32,
                                                (4, 4), (4, 4), 0))


def test_sam_blocks_route_by_kind_and_match_the_old_forward():
    """Global blocks take the wrapper, windowed blocks the plain chain; on the
    CPU each block's attention equals the old forward bit for bit."""
    from cm3d_tpu_torch.models.common import cast_compute_weights_, init_weights
    from cm3d_tpu_torch.models.sam import SAM_TEST, Sam

    cfg = dataclasses.replace(SAM_TEST, dtype="bfloat16")
    model = cast_compute_weights_(init_weights(Sam(cfg), torch.Generator().manual_seed(0)))
    blocks = model.image_encoder.blocks
    assert [blk.attn.global_attn for blk in blocks] == [
        i in cfg.encoder_global_attn for i in range(cfg.encoder_depth)]
    rng = np.random.default_rng(1)
    for blk in blocks:
        a = blk.attn
        side = blk.window or cfg.embed_hw
        x = torch.from_numpy(rng.standard_normal((2, side, side, cfg.encoder_dim)).astype(
            np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            got = a(x)
            qkv = a.qkv(x.reshape(2, side * side, -1)).reshape(2, side * side, 3, a.heads, -1)
            q, k, v = qkv.unbind(2)
            want = a.proj(_old_chain(q, k, v, a.rel_pos_h, a.rel_pos_w, a.dtype, (side, side),
                                     (side, side), 0).reshape(2, side, side, -1))
        assert torch.equal(got, want)


def test_a_block_resizes_its_tables_once_while_they_hold():
    """A rect encode's global block interpolates its h table once and keeps
    it while the parameters are unchanged; an in-place change or another
    key grid makes the tables anew, and under autograd they are made in
    each call, in the graph."""
    from cm3d_tpu_torch.models.sam import Attention

    bf16 = torch.bfloat16
    a = Attention(32, 2, (8, 8), bf16, global_attn=True)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        a.rel_pos_h.normal_(generator=g)
        a.rel_pos_w.normal_(generator=g)
        first = a.rel_tables(5, 8)
        assert a.rel_tables(5, 8)[0] is first[0] and a.rel_tables(5, 8)[1] is first[1]
        assert first[0].shape == (9, 16) and first[0].dtype == torch.float32  # resized
        assert first[1].shape == (15, 16) and first[1].dtype == bf16
        assert torch.equal(first[0], resize_rel_pos(a.rel_pos_h.to(bf16), 9))
        a.rel_pos_h.add_(1.0)
        second = a.rel_tables(5, 8)
        assert second[0] is not first[0]
        assert torch.equal(second[0], resize_rel_pos(a.rel_pos_h.to(bf16), 9))
        assert a.rel_tables(8, 8)[0].shape == (15, 16)
    h, w = a.rel_tables(5, 8)
    assert h.requires_grad and w.requires_grad and h is not a.rel_tables(5, 8)[0]


def test_route_takes_wgmma_at_every_sam_shape():
    bf16 = torch.bfloat16
    for hd, kh, gw in ((80, 64, 64), (64, 64, 64), (64, 36, 64), (80, 64, 64)):
        assert route(bf16, hd, kh, gw) == "wgmma"
    assert route(torch.float32, 80, 64, 64) == "simt"
    assert route(bf16, 16, 4, 4) == "simt"  # SAM_TEST's head dim
    assert route(bf16, 80, 65, 64) == "simt"


def test_resize_rel_pos_is_linear_interpolation():
    g = torch.Generator().manual_seed(2)
    table = torch.randn(127, 64, generator=g)
    got = resize_rel_pos(table, 71)
    want = torch.nn.functional.interpolate(table.T[None], size=71, mode="linear",
                                           align_corners=False)[0].T
    # the two compute the source positions in f32 by other formulas
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert resize_rel_pos(table, 127) is table
    # get_rel_pos still resizes as it did, through the same function
    idx = get_rel_pos(36, 36, table)
    assert torch.equal(idx[0, 35], got[0]) and torch.equal(idx[35, 0], got[70])


def test_bad_input_raises():
    q, k, v, rel_h, rel_w = _inputs(1, 4, 4, 4, 0, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="sam_global_attn"):
        sam_global_attn(q, k, v, rel_h, rel_w, q_hw=(4, 5), k_hw=(4, 4))
    with pytest.raises(ValueError, match="sam_global_attn"):
        sam_global_attn(q, k, v, rel_h, rel_w, q_hw=(4, 4), k_hw=(4, 4), row0=1)
    with pytest.raises(ValueError, match="sam_global_attn"):
        sam_global_attn(q, k[:, :, :1], v, rel_h, rel_w, q_hw=(4, 4), k_hw=(4, 4))
    with pytest.raises(ValueError, match="sam_global_attn"):
        sam_global_attn(q, k, v, rel_h[:, :4], rel_w, q_hw=(4, 4), k_hw=(4, 4))


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ref64(q, k, v, rel_h, rel_w, q_hw, k_hw, row0):
    """The function in float64, from the same (resized) tables."""
    (qh, gw), kh = q_hw, k_hw[0]
    q, k, v, rel_h, rel_w = (t.double() for t in (q, k, v, rel_h, rel_w))
    b, qn, heads, hd = q.shape
    s = torch.einsum("bqhc,bkhc->bhqk", q, k) * hd ** -0.5
    qi, kj = torch.arange(qn, device=q.device), torch.arange(kh * gw, device=q.device)
    ih = (row0 + qi // gw)[:, None] - (kj // gw)[None] + kh - 1
    iw = (qi % gw)[:, None] - (kj % gw)[None] + gw - 1
    shape = (b, heads, qn, kh * gw)
    s = s + torch.gather(torch.einsum("bqhc,uc->bhqu", q, rel_h), -1, ih.expand(shape))
    s = s + torch.gather(torch.einsum("bqhc,uc->bhqu", q, rel_w), -1, iw.expand(shape))
    return torch.einsum("bhqk,bkhc->bqhc", torch.softmax(s, -1), v).reshape(b, qn, -1)


CARD_CASES = [
    # name: b, qh, gw, kh, row0, heads, hd, dtype, h table rows
    ("vit_h_square", (1, 64, 64, 64, 0, 16, 80, torch.bfloat16, None)),
    ("vit_l", (1, 64, 64, 64, 0, 16, 64, torch.bfloat16, None)),
    ("vit_b_rect", (1, 36, 64, 36, 0, 12, 64, torch.bfloat16, 127)),  # interpolated table
    ("row0_slice", (1, 16, 64, 64, 32, 16, 80, torch.bfloat16, None)),  # whole-map keys
    ("f32", (1, 32, 32, 32, 0, 16, 80, torch.float32, None)),
    ("ragged_grid", (2, 12, 20, 12, 0, 4, 64, torch.bfloat16, 31)),  # tiles across grid rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_error_no_larger_than_the_chain(cuda, name, case):
    b, qh, gw, kh, row0, heads, hd, dtype, rows_h = case
    q, k, v, rel_h, rel_w = _inputs(b, qh, gw, kh, row0, heads, hd, dtype, rows_h, device=cuda)
    rel_h, rel_w = rel_h.to(dtype), rel_w.to(dtype)
    kw = dict(q_hw=(qh, gw), k_hw=(kh, gw), row0=row0)
    before = sam_global_attn.launches
    with torch.no_grad():
        got = sam_global_attn(q, k, v, rel_h, rel_w, **kw)
        torch.cuda.synchronize()
        assert sam_global_attn.launches == before + 1
        th, tw = resize_rel_pos(rel_h, 2 * kh - 1), resize_rel_pos(rel_w, 2 * gw - 1)
        chain = relpos_attention(q, k, v, th, tw, **kw)
        want = _ref64(q, k, v, th, tw, **kw)
    top = float(want.abs().max())
    err = float((got.double() - want).abs().max()) / top
    err_chain = float((chain.double() - want).abs().max()) / top
    assert got.dtype == dtype and got.shape == (b, qh * gw, heads * hd)
    if dtype == torch.bfloat16:
        assert err <= err_chain, (err, err_chain)
    else:
        assert err <= 2 * err_chain, (err, err_chain)


@pytest.mark.cuda
def test_kernel_gives_equal_bits_twice(cuda):
    q, k, v, rel_h, rel_w = _inputs(1, 36, 64, 36, 0, 12, 64, torch.bfloat16, 127, device=cuda)
    kw = dict(q_hw=(36, 64), k_hw=(36, 64))
    with torch.no_grad():
        first = sam_global_attn(q, k, v, rel_h.bfloat16(), rel_w.bfloat16(), **kw)
        second = sam_global_attn(q, k, v, rel_h.bfloat16(), rel_w.bfloat16(), **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_vit_h_encode_launches_four_a_camera(cuda):
    """A ViT-H encode of two cameras, one at a time as the pipelines run it:
    the four global blocks launch the kernel once each, the 28 windowed
    blocks never; the H2D copies of rel-pos indices are the windowed
    blocks' alone."""
    from cm3d_tpu_torch.kernels.window_attn_relpos import window_attn_relpos_heads
    from cm3d_tpu_torch.models.common import cast_compute_weights_, init_weights
    from cm3d_tpu_torch.models.sam import SAM_VIT_H, Sam

    cfg = dataclasses.replace(SAM_VIT_H, dtype="bfloat16")
    with torch.device(cuda):
        model = init_weights(Sam(cfg), torch.Generator(device=cuda).manual_seed(0))
    model = cast_compute_weights_(model).eval()
    x = torch.randn(2, 1024, 1024, 3, device=cuda)
    before = (sam_global_attn.launches, window_attn_relpos_heads.launches)
    with torch.inference_mode():
        for i in range(2):
            emb = model.encode_image(x[i:i + 1])
    torch.cuda.synchronize()
    assert (sam_global_attn.launches - before[0], window_attn_relpos_heads.launches
            - before[1]) == (2 * len(cfg.encoder_global_attn), 0)
    assert bool(torch.isfinite(emb).all())


@pytest.mark.cuda
def test_card_refuses_a_graph(cuda):
    q, k, v, rel_h, rel_w = _inputs(1, 4, 4, 4, 0, 2, 64, torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        sam_global_attn(q.clone().requires_grad_(), k, v, rel_h, rel_w, q_hw=(4, 4),
                        k_hw=(4, 4))


@pytest.mark.cuda
def test_card_never_runs_the_chain(cuda, monkeypatch):
    """On a CUDA tensor the op launches the kernel: the plain chain is not
    called, whatever the shape."""
    def boom(*a, **kw):
        raise AssertionError("the plain chain ran on the card")

    monkeypatch.setattr(sga, "relpos_attention", boom)
    monkeypatch.setattr(relpos_attn, "add_decomposed_rel_pos_bnhc", boom)
    for case in (CARD_CASES[2][1], CARD_CASES[5][1], CARD_CASES[4][1]):
        b, qh, gw, kh, row0, heads, hd, dtype, rows_h = case
        q, k, v, rel_h, rel_w = _inputs(b, qh, gw, kh, row0, heads, hd, dtype, rows_h,
                                        device=cuda)
        with torch.no_grad():
            sam_global_attn(q, k, v, rel_h.to(dtype), rel_w.to(dtype), q_hw=(qh, gw),
                            k_hw=(kh, gw), row0=row0)
