"""Small inputs for every `cm3d_torch::` dispatcher op (kernels/ops.py), for
`torch.library.opcheck` on the CPU (tests/test_torch_kernels.py) and on the
card (tests/test_torch_cuda.py). Imports only torch and the port.

The window-attention cases use C = 16 and 16-byte aligned tensors, which
the bf16 GEMM on the card asks for; the bf16 cases pass bf16 weights."""

import torch

# every op the port registers, by case: (op name, compute dtype or None)
CASES = [
    ("compact_rows", None),
    ("medoid_sums", None),
    ("segment_sum_max", None),
    ("segment_sum", None),
    ("segment_sum_bwd", None),
    *[(op, dt) for op in ("window_attn_heads", "window_attn_qkv", "window_attn_proj",
                          "window_attn_relpos_heads", "window_attn_relpos_proj",
                          "sam_global_attn")
      for dt in ("float32", "bfloat16")],
]


def case_ids():
    return [op if dt is None else f"{op}-{dt}" for op, dt in CASES]


def op_and_args(op: str, dtype, device):
    """(the op's overload, its arguments on `device`), seeded."""
    import cm3d_tpu_torch.kernels.compact  # noqa: F401  (registers the ops)
    import cm3d_tpu_torch.kernels.medoid  # noqa: F401
    import cm3d_tpu_torch.kernels.sam_global_attn  # noqa: F401
    import cm3d_tpu_torch.kernels.segment  # noqa: F401
    import cm3d_tpu_torch.kernels.window_attn  # noqa: F401
    import cm3d_tpu_torch.kernels.window_attn_relpos  # noqa: F401

    gen = torch.Generator().manual_seed(0)

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen).to(device=device, dtype=dt)

    if op == "compact_rows":
        sel = (torch.rand(3, 50, generator=gen) > 0.5).to(device)
        args = (sel, r(3, 4, 50), 20)
    elif op == "medoid_sums":
        valid = torch.zeros(2, 40, dtype=torch.bool)
        valid[:, :30] = True
        args = (r(2, 3, 40), valid.to(device))
    elif op == "sam_global_attn":
        # a 4 x 4 grid, 2 heads of 64: q, k, v as views of one qkv; tables of 2 * 4 - 1 rows
        dt = getattr(torch, dtype)
        q, k, v = r(1, 16, 3, 2, 64, dt=dt).unbind(2)
        args = (q, k, v, r(7, 64, dt=dt), r(7, 64, dt=dt), [4, 4], [4, 4], 0)
    elif op.startswith("segment"):
        cell = torch.sort(torch.randint(0, 12, (2, 30), generator=gen, dtype=torch.int32),
                          dim=1).values.to(device)
        args = {"segment_sum_max": (cell, r(2, 5, 30), r(2, 30), 10),
                "segment_sum": (cell, r(2, 5, 30), 10),
                "segment_sum_bwd": (cell, r(2, 5, 10))}[op]
    else:
        dt = getattr(torch, dtype)
        c, heads, win, shift = 16, 2, 4, 2
        x = r(1, 6, 7, c)
        ln = (r(c), r(c))
        wqkv, bqkv = r(3 * c, c, dt=dt), r(3 * c)
        o = r(8 * 8, c, dt=dt)
        proj = (r(c, c, dt=dt), r(c), [1, 6, 7, c], heads, win)
        rel = (r(2 * win - 1, c // heads, dt=dt), r(2 * win - 1, c // heads, dt=dt))
        args = {
            "window_attn_heads": (x, *ln, wqkv, bqkv, r((2 * win - 1) ** 2, heads), heads,
                                  win, shift, dt, 1e-5),
            "window_attn_qkv": (x, *ln, wqkv, bqkv, win, shift, dt, 1e-5),
            "window_attn_proj": (o, *proj, shift, dt),
            "window_attn_relpos_heads": (x, *ln, wqkv, bqkv, *rel, heads, win, dt, 1e-6),
            "window_attn_relpos_proj": (o, *proj, dt),
        }[op]
    return getattr(torch.ops.cm3d_torch, op).default, args
