"""Weights from the seed, made by the benchmark and handed to both sides.

Every parameter of the reference modules is drawn from ONE normal sample of
all their sizes together, made on the device by a torch.Generator seeded
with the run's seed, and rounded to the type the configuration serves
(bfloat16): the program loads those values, and the reference computes with
the same values in float32. Scales: linear and convolution weights
normal(0, 1/fan_in) (lecun normal, as the published models' inits),
embeddings normal(0, 1), norm weights 1 + normal(0, 0.1), biases and the
position tables normal(0, 0.02).
"""

from __future__ import annotations

import math

import torch
from torch import nn

TABLES = ("relative_position_bias_table", "rel_pos_h", "rel_pos_w", "pos_embed")
NORMS = (nn.LayerNorm, nn.GroupNorm)


def _scale(module: nn.Module, name: str, p: torch.Tensor):
    """(mean, std) of parameter `name` of `module`."""
    if name == "positional_encoding_gaussian_matrix" or isinstance(module, nn.Embedding):
        return 0.0, 1.0
    if name == "scale":
        return 1.0, 0.0
    if name in TABLES or name == "bias" or name == "cls_bias":
        return 0.0, 0.02
    if name == "weight" and (isinstance(module, NORMS) or p.ndim == 1):
        return 1.0, 0.1
    if isinstance(module, nn.ConvTranspose2d):
        return 0.0, 1.0 / math.sqrt(p.shape[0] * p.shape[2] * p.shape[3])
    return 0.0, 1.0 / math.sqrt(p[0].numel())


def make_state(modules: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{prefix: module} -> {prefix: state dict} of seeded values in `dtype`
    on `device`: one normal sample in `dtype`, each parameter a view of it
    scaled in place."""
    plan = []
    for prefix, root in modules.items():
        for mname, mod in root.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                key = f"{mname}.{pname}" if mname else pname
                plan.append((prefix, key, tuple(p.shape), *_scale(mod, pname, p)))
    total = sum(math.prod(shape) for _, _, shape, _, _ in plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: dict = {prefix: {} for prefix in modules}
    off = 0
    for prefix, key, shape, mean, std in plan:
        n = math.prod(shape)
        out[prefix][key] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def classifier(embed_dim: int, n_words: int, seed: int, device) -> torch.Tensor:
    """Text embeddings of the vocabulary: unit columns [embed_dim, n_words]
    in float32, as CLIP's normalised text features."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    c = torch.randn((embed_dim, n_words), generator=gen, device=device)
    return c / c.norm(dim=0, keepdim=True)
