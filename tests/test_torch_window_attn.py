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
    window_attn_heads_plain,
    window_attn_plain,
    window_attn_proj,
    window_attn_proj_plain,
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
