"""The port's SAM rel-pos window attention (kernels/window_attn_relpos.py)
against the JAX package's `fused_window_attn_relpos` on the CPU.

The same numpy inputs go to the Pallas kernel in interpret mode and to the
port's plain version, in f32. Tolerance: atol = rtol = 1e-4 (the JAX
package holds its own kernel to its numpy reference at 3e-4); the two
compute the same function and differ in summation order. The JAX kernel
wants a grid already padded to the window (and to its group of windows),
with `bounds` naming the real extent, as `cm3d_tpu/models/sam.py:284-294`
calls it; the port's wrapper pads and crops in its own addressing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cm3d_tpu.kernels.window_attn_pallas import fused_window_attn_relpos

from cm3d_tpu_torch.kernels.window_attn_relpos import (
    rel_index,
    window_attn_relpos,
    window_attn_relpos_heads,
    window_attn_relpos_heads_plain,
    window_attn_relpos_plain,
    window_attn_relpos_proj,
)

TOL = 1e-4


def _inputs(b, h, w, c, heads, win, seed):
    rng = np.random.default_rng(seed)
    hd = c // heads
    return (
        rng.standard_normal((b, h, w, c)).astype(np.float32),
        (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32),  # flax [in, out]
        (0.1 * rng.standard_normal(3 * c)).astype(np.float32),
        (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.3 * rng.standard_normal((2 * win - 1, hd))).astype(np.float32),
        (0.3 * rng.standard_normal((2 * win - 1, hd))).astype(np.float32),
    )


def _port_args(args):
    """numpy (flax layouts) -> torch (nn.Linear layouts)."""
    x, g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w = (torch.from_numpy(a) for a in args)
    return x, g, b, wqkv.T.contiguous(), bqkv, wproj.T.contiguous(), bproj, rel_h, rel_w


def _jax_fused(args, win, G, heads, hw=None):
    """The Pallas kernel in interpret mode; `hw` = the real extent of a grid
    that the caller padded (cm3d_tpu/models/sam.py _fused_windowed)."""
    x = args[0]
    bounds = None
    if hw is not None:
        h, w = hw
        hp, wp = -(-h // win) * win, -(-w // win) * win
        n_gx = -(-(wp // win) // G)
        x = np.pad(x, ((0, 0), (0, hp - h), (0, n_gx * G * win - w), (0, 0)))
        bounds = (h, w, wp, 0)
    out = fused_window_attn_relpos(jnp.asarray(x), *args[1:], win=win, G=G, heads=heads,
                                   dtype="float32", interpret=True, bounds=bounds)
    out = np.asarray(out)
    return out if hw is None else out[:, :hw[0], :hw[1]]


# the three shapes of tests/test_window_attn_pallas.py:184-188
@pytest.mark.parametrize("win,G,n_wy,n_gx,c,heads", [
    (4, 2, 2, 2, 32, 4),
    (7, 1, 2, 3, 64, 8),
    (2, 3, 2, 1, 16, 2),
])
def test_plain_matches_jax_fused_interpret(win, G, n_wy, n_gx, c, heads):
    args = _inputs(2, n_wy * win, n_gx * G * win, c, heads, win, seed=21)
    want = _jax_fused(args, win, G, heads)
    got = window_attn_relpos_plain(*_port_args(args), heads=heads, window=win,
                                   dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,w,win,G", [(4, 4, 3, 1), (5, 9, 4, 2), (10, 7, 3, 2)])
def test_plain_matches_jax_on_a_grid_the_window_does_not_divide(h, w, win, G):
    """Padding tokens are zeros AFTER the LN: they are keys of the edge
    windows with k = v = the bare bias, and their outputs are cropped."""
    args = _inputs(2, h, w, 32, 2, win, seed=5)
    want = _jax_fused(args, win, G, 2, hw=(h, w))
    got = window_attn_relpos_plain(*_port_args(args), heads=2, window=win,
                                   dtype=torch.float32).numpy()
    assert got.shape == (2, h, w, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16_plain_follows_the_jax_kernels_rounding():
    """bf16: the port's plain version against the Pallas kernel in bf16,
    both rounding LN out, qkv, the bias terms, p, o and out. Tolerance 2^-5
    of max|ref| (four bf16 ulps at the top of the range): the two sum in
    different orders, so values round to neighbouring bf16 numbers."""
    win, G, heads = 4, 2, 4
    args = _inputs(2, 8, 16, 32, heads, win, seed=7)
    want = np.asarray(fused_window_attn_relpos(
        jnp.asarray(args[0]), *args[1:], win=win, G=G, heads=heads, dtype="bfloat16",
        interpret=True).astype(jnp.float32))
    got = window_attn_relpos_plain(*_port_args(args), heads=heads, window=win,
                                   dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -5 * np.abs(want).max(), (err, np.abs(want).max())
    # and it is the f32 function up to that rounding, not something else
    f32 = window_attn_relpos_plain(*_port_args(args), heads=heads, window=win,
                                   dtype=torch.float32)
    assert 0 < float((got.float() - f32).abs().max()) <= 2.0 ** -5 * float(f32.abs().max())


@pytest.mark.parametrize("win", [2, 3, 14])
def test_rel_index_is_the_decomposed_offset(win):
    idx_h, idx_w = rel_index(win)
    for i in (0, win * win // 2, win * win - 1):
        for j in (0, win, win * win - 1):
            assert idx_h[i, j] == i // win - j // win + win - 1
            assert idx_w[i, j] == i % win - j % win + win - 1
    assert idx_h.min() == idx_w.min() == 0 and idx_h.max() == idx_w.max() == 2 * win - 2


def test_cpu_wrappers_run_the_plain_version_and_launch_nothing():
    x, g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w = _port_args(
        _inputs(2, 5, 7, 16, 2, 3, seed=3))
    kw = dict(heads=2, window=3, dtype=torch.float32)
    before = (window_attn_relpos_heads.launches, window_attn_relpos_proj.launches)
    o = window_attn_relpos_heads(x, g, b, wqkv, bqkv, rel_h, rel_w, **kw)
    assert torch.equal(o, window_attn_relpos_heads_plain(x, g, b, wqkv, bqkv, rel_h, rel_w, **kw))
    # o: one row per token of the padded grid (6 x 9 here), window order
    assert tuple(o.shape) == (2 * 6 * 9, 16)
    out = window_attn_relpos_proj(o, wproj, bproj, out_shape=tuple(x.shape), **kw)
    assert torch.equal(out, window_attn_relpos(x, g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w,
                                               **kw))
    assert torch.equal(out, window_attn_relpos_plain(x, g, b, wqkv, bqkv, wproj, bproj, rel_h,
                                                     rel_w, **kw))
    assert (window_attn_relpos_heads.launches, window_attn_relpos_proj.launches) == before


def test_eps_is_the_callers():
    """SAM's LayerNorm eps is 1e-6, Swin's 1e-5: on low-variance tokens the
    two differ, so the wrapper must use what it is passed."""
    args = list(_port_args(_inputs(1, 4, 4, 16, 2, 2, seed=9)))
    args[0] = args[0] * 1e-3
    kw = dict(heads=2, window=2, dtype=torch.float32)
    a = window_attn_relpos(*args, eps=1e-6, **kw)
    b = window_attn_relpos(*args, eps=1e-5, **kw)
    assert torch.equal(a, window_attn_relpos(*args, **kw))  # the default is SAM's
    assert float((a - b).abs().max()) > 1e-3


def test_bad_input_raises():
    x, g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w = _port_args(
        _inputs(1, 4, 4, 16, 2, 2, seed=11))
    kw = dict(window=2, dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        window_attn_relpos(x, g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w, heads=3, **kw)
    with pytest.raises(ValueError, match="tables"):  # tables of another window
        window_attn_relpos(x, g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w, heads=2, window=3,
                           dtype=torch.float32)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        window_attn_relpos(x[0], g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w, heads=2, **kw)
    with pytest.raises(ValueError, match="wqkv"):
        window_attn_relpos(x, g, b, wqkv.T[:, :16], bqkv, wproj, bproj, rel_h, rel_w, heads=2,
                           **kw)
    o = window_attn_relpos_heads(x, g, b, wqkv, bqkv, rel_h, rel_w, heads=2, **kw)
    with pytest.raises(ValueError, match="do not fit"):
        window_attn_relpos_proj(o[:-1], wproj, bproj, out_shape=tuple(x.shape), heads=2, **kw)
