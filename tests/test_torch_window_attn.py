"""The port's window attention (kernels/window_attn.py) against the JAX
package's Swin attention branch on the CPU.

The same numpy inputs go to JAX `models/swin.py:198 _fused_branch_impl`
(the Pallas kernel in interpret mode), to `:260 _attn_branch_xla` and to
the port's plain version, in f32. Tolerance: 1e-5 of the output's largest
magnitude (about 2.5 units of f32 rounding there); the three compute the
same function and differ in summation order, and the XLA branch also in its
one-pass LayerNorm variance and in scaling q before the dot.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cm3d_tpu.models.swin import (
    _attn_branch_xla,
    _fused_branch_impl,
    _rel_pos_index,
    _shift_attn_mask,
)

from cm3d_tpu_torch.kernels.window_attn import (
    rel_pos_index,
    shift_attn_mask,
    window_attn,
    window_attn_heads,
    window_attn_core_plain,
    window_attn_heads_plain,
    window_attn_plain,
    window_attn_proj,
    window_attn_proj_plain,
    window_attn_qkv_plain,
)

TOL = 1e-5  # x max|out|

# (B, H, W, C, heads, window, shift): shift 0 and > 0, H and W divisible by
# the window and not (the padding / bounds path), several windows per row
SHAPES = [
    (2, 8, 8, 16, 2, 4, 0),
    (2, 8, 12, 16, 2, 4, 2),
    (1, 10, 13, 32, 4, 4, 2),
    (1, 9, 15, 16, 2, 3, 1),
    (2, 14, 21, 32, 2, 7, 3),
    (1, 6, 17, 16, 2, 4, 0),
    (1, 5, 8, 32, 2, 5, 0),  # the window shrunk to 5 (Swin-T's stage 3 map)
    (1, 9, 16, 96, 3, 7, 3),  # Swin-T widths: C 96, 3 heads of 32
]

# the shapes the kernels' pieces are pinned at: a padded grid without and
# with shift, the shrunk window 5, Swin-T widths, C 16 with head dim 8
PIECE_SHAPES = [
    (2, 9, 14, 32, 2, 4, 0),
    (2, 9, 14, 32, 2, 4, 2),
    (1, 5, 8, 32, 2, 5, 0),
    (1, 9, 16, 96, 3, 7, 3),
    (2, 9, 15, 16, 2, 3, 1),
]


def _inputs(shape, seed):
    b, h, w, c, heads, win, _ = shape
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, w, c)).astype(np.float32),
        (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32),  # flax [in, out]
        (0.1 * rng.standard_normal(3 * c)).astype(np.float32),
        (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.5 * rng.standard_normal(((2 * win - 1) ** 2, heads))).astype(np.float32),
    )


def _port_args(args):
    """numpy (flax layouts) -> torch (nn.Linear layouts)."""
    x, g, b, wqkv, bqkv, wproj, bproj, table = (torch.from_numpy(a) for a in args)
    return x, g, b, wqkv.T.contiguous(), bqkv, wproj.T.contiguous(), bproj, table


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_fused_interpret(shape):
    _, _, _, c, heads, win, shift = shape
    args = _inputs(shape, 1)
    want = _fused_branch_impl(
        jnp.asarray(args[0]), tuple(jnp.asarray(a) for a in args[1:]), window=win,
        shift=shift, heads=heads, dim=c, dtype=jnp.float32, group_tokens=128, interpret=True)
    got = window_attn_plain(*_port_args(args), heads=heads, window=win, shift=shift,
                            dtype=torch.float32)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_xla_branch(shape):
    _, _, _, c, heads, win, shift = shape
    args = _inputs(shape, 2)
    want = _attn_branch_xla(jnp.asarray(args[0]), tuple(jnp.asarray(a) for a in args[1:]),
                            window=win, shift=shift, heads=heads, dim=c, dtype=jnp.float32)
    got = window_attn_plain(*_port_args(args), heads=heads, window=win, shift=shift,
                            dtype=torch.float32)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,shift,hp,wp", [(4, 2, 8, 12), (7, 3, 21, 35), (3, 1, 9, 15)])
def test_index_and_mask_match_jax(window, shift, hp, wp):
    np.testing.assert_array_equal(rel_pos_index(window), _rel_pos_index(window))
    np.testing.assert_array_equal(shift_attn_mask(hp, wp, window, shift),
                                  _shift_attn_mask(hp, wp, window, shift))


def test_cpu_wrappers_run_the_plain_version_and_launch_nothing():
    shape = (2, 9, 14, 16, 2, 4, 2)
    _, _, _, _, heads, win, shift = shape
    x, g, b, wqkv, bqkv, wproj, bproj, table = _port_args(_inputs(shape, 3))
    kw = dict(heads=heads, window=win, shift=shift, dtype=torch.float32)
    before = (window_attn_heads.launches, window_attn_proj.launches)
    o = window_attn_heads(x, g, b, wqkv, bqkv, table, **kw)
    assert torch.equal(o, window_attn_heads_plain(x, g, b, wqkv, bqkv, table, **kw))
    out = window_attn_proj(o, wproj, bproj, out_shape=tuple(x.shape), **kw)
    assert torch.equal(out, window_attn_proj_plain(o, wproj, bproj, out_shape=tuple(x.shape),
                                                   window=win, shift=shift,
                                                   dtype=torch.float32))
    assert torch.equal(window_attn(x, g, b, wqkv, bqkv, wproj, bproj, table, **kw), out)
    assert (window_attn_heads.launches, window_attn_proj.launches) == before
    # o: one row per token of the padded grid (12 x 16 here), window order
    assert tuple(o.shape) == (2 * 12 * 16, 16)


def test_bf16_plain_rounds_like_the_kernel():
    """The bf16 plain version is the f32 one with qkv, p, o and out rounded
    to bf16: it stays within bf16 rounding (2^-5 of the range) of f32."""
    shape = (1, 10, 13, 32, 4, 4, 2)
    _, _, _, _, heads, win, shift = shape
    args = _port_args(_inputs(shape, 4))
    kw = dict(heads=heads, window=win, shift=shift)
    got = window_attn_plain(*args, dtype=torch.bfloat16, **kw)
    want = window_attn_plain(*args, dtype=torch.float32, **kw)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max())
    assert 0 < err <= 2.0 ** -5 * float(want.abs().max())


def test_rejects_heads_not_dividing_channels():
    x, g, b, wqkv, bqkv, wproj, bproj, table = _port_args(_inputs((1, 8, 8, 16, 2, 4, 0), 5))
    with pytest.raises(ValueError, match="not divisible"):
        window_attn(x, g, b, wqkv, bqkv, wproj, bproj, table, heads=3, window=4, shift=0,
                    dtype=torch.float32)
    with pytest.raises(ValueError, match="shift"):
        window_attn(x, g, b, wqkv, bqkv, wproj, bproj, table, heads=2, window=4, shift=4,
                    dtype=torch.float32)


def test_rejects_a_bias_table_of_another_window():
    x, g, b, wqkv, bqkv, wproj, bproj, table = _port_args(_inputs((1, 8, 8, 16, 2, 4, 0), 5))
    with pytest.raises(ValueError, match="bias table"):
        window_attn(x, g, b, wqkv, bqkv, wproj, bproj, table, heads=2, window=3, shift=0,
                    dtype=torch.float32)


def _heads_plain_in_one(x, ln_weight, ln_bias, wqkv, bqkv, table, *, heads, window, shift,
                        dtype, eps=1e-5):
    """The first launch's plain version as one function, the form it had
    before it was cut into the qkv product and the attention."""
    b, h, w, c = x.shape
    hd, n = c // heads, window * window
    hp, wp = -(-h // window) * window, -(-w // window) * window
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    ln = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * ln_weight.float() \
        + ln_bias.float()
    ln = torch.nn.functional.pad(ln, (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        ln = torch.roll(ln, (-shift, -shift), (1, 2))
    ln = ln.reshape(b, hp // window, window, wp // window, window, c)
    ln = ln.permute(0, 1, 3, 2, 4, 5).reshape(-1, n, c)
    qkv = ln.to(dtype).float() @ wqkv.to(dtype).float().T + bqkv.float()
    qkv = qkv.to(dtype).float().reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    idx = torch.as_tensor(rel_pos_index(window)).reshape(-1)
    bias = table.float()[idx].reshape(n, n, heads).permute(2, 0, 1)
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias
    if shift:
        mask = torch.as_tensor(shift_attn_mask(hp, wp, window, shift))
        s = (s.reshape(b, -1, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
    p = torch.softmax(s, dim=-1).to(dtype).float()
    o = (p @ v).to(dtype).float()
    return o.permute(0, 2, 1, 3).reshape(-1, c).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PIECE_SHAPES)
def test_plain_pieces_compose_to_the_heads_plain_bit_for_bit(shape, dtype):
    b, h, w, c, heads, win, shift = shape
    x, g, bb, wqkv, bqkv, _, _, table = _port_args(_inputs(shape, 6))
    if dtype == torch.bfloat16:
        x = x.bfloat16()
    kw = dict(window=win, shift=shift, dtype=dtype)
    qkv = window_attn_qkv_plain(x, g, bb, wqkv, bqkv, **kw)
    hp, wp = -(-h // win) * win, -(-w // win) * win
    assert qkv.dtype == dtype and tuple(qkv.shape) == (b * hp * wp, 3 * c)
    o = window_attn_core_plain(qkv, table, x_shape=tuple(x.shape), heads=heads, **kw)
    want = _heads_plain_in_one(x, g, bb, wqkv, bqkv, table, heads=heads, **kw)
    assert o.dtype == dtype and torch.equal(o, want)
    assert torch.equal(window_attn_heads_plain(x, g, bb, wqkv, bqkv, table, heads=heads, **kw),
                       want)


def test_qkv_plain_gives_padding_tokens_the_bias():
    shape = (1, 5, 6, 16, 2, 4, 2)  # padded to 8 x 8
    _, _, _, _, _, win, shift = shape
    x, g, bb, wqkv, bqkv, _, _, _ = _port_args(_inputs(shape, 7))
    qkv = window_attn_qkv_plain(x, g, bb, wqkv, bqkv, window=win, shift=shift,
                                dtype=torch.float32)
    # rolled padded grid (r, c) reads x at ((r + 2) % 8, (c + 2) % 8): row 3
    # of the grid reads source row 5, a padding row, so window 0's token at
    # (3, 0) is padding
    assert torch.equal(qkv[3 * win], bqkv)
    assert not torch.equal(qkv[0], bqkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PIECE_SHAPES)
def test_cpu_wrappers_launch_nothing_at_the_piece_shapes(shape, dtype):
    _, _, _, _, heads, win, shift = shape
    x, g, bb, wqkv, bqkv, wproj, bproj, table = _port_args(_inputs(shape, 8))
    kw = dict(heads=heads, window=win, shift=shift, dtype=dtype)
    before = (window_attn_heads.launches, window_attn_proj.launches)
    out = window_attn(x, g, bb, wqkv, bqkv, wproj, bproj, table, **kw)
    assert torch.equal(out, window_attn_plain(x, g, bb, wqkv, bqkv, wproj, bproj, table, **kw))
    assert (window_attn_heads.launches, window_attn_proj.launches) == before
