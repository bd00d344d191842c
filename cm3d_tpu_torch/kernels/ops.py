"""The port's CUDA launchers as PyTorch dispatcher ops (namespace `cm3d_torch`).

Each launcher is one op with three implementations:
- CUDA: the launcher through ctypes, which counts the launch on its
  wrapper's `.launches`; a CUDA tensor never falls back to the plain version;
- CPU: the plain PyTorch version;
- fake: the output shapes and dtypes alone.

So `torch.export` traces a kernel as one node of the program (deploy.py),
a loaded program launches the same kernels as the in-process step, and a
trace runs no implementation but the fake one: tracing counts nothing. The
ops register no autograd kernel; the differentiable wrappers
(`segment.py _SegmentSum`, `window_attn.py _WindowAttn`) are
`autograd.Function`s around them.

The ops are registered with `torch.library.Library` (`define` / `impl`)
and `register_fake`, not `torch.library.custom_op`, whose Python layers
add host time to every call: the lift step and the mask stage are bound by
the host.
"""

from __future__ import annotations

import torch

NAMESPACE = "cm3d_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, *, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Register the op `schema` (``name(args) -> outs``) with its CPU, CUDA
    and fake implementations; returns the op's overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
