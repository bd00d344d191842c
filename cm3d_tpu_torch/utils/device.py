"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. A CUDA device on a machine without one raises; nothing falls
    back to the CPU behind the caller's back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if device.index is None:  # name the card, as tensors' devices do
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def strict_f32() -> None:
    """Full-f32 matmuls AND convolutions on the card. PyTorch's f32 matmuls
    default to full f32 already, but cuDNN runs f32 convolutions in TF32
    (about three decimal digits) unless told not to; f32 runs of the 2D
    models (strict parity) need both off. Process-wide, like the flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def strict_f32_scope():
    """`strict_f32` for the body only; the flags come back as they were."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    strict_f32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
