"""Save / load of the port's own parameter trees (train state, deploy
checkpoint). Mirrors the save / load half of `cm3d_tpu/models/checkpoints.py`.

A tree is a nested dict whose leaves are tensors, ints, floats or None:
`TrainState.tree()` (params, batch statistics, optimizer moments and count,
step, EMA) or the deploy tree {"params", "batch_stats"}. A checkpoint is a
directory (as the JAX package's are) holding one `tree.pt`, written with
`torch.save` and read back with `weights_only=True`, so loading runs no
pickled code. Tensors are saved from, and loaded to, the CPU; the caller
copies them into its live tensors.

`load_released_checkpoint` is the model CLIs' dispatch between such a
directory (an already-converted state dict, saved with `save_params`) and a
released torch file (Detic, SAM, CLIP), which goes through its converter in
`models/convert.py`.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch

_FILE = "tree.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {str(k): _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if tree is None or isinstance(tree, (int, float, bool, str)):
        return tree
    raise TypeError(f"save_params: unsupported leaf {type(tree).__name__}")


def save_params(params: Any, path: str, overwrite: bool = False) -> None:
    """Write `params` (a nested dict of tensors and scalars) to the
    directory `path`. The file appears under its name only once it is
    complete, so a killed run leaves no half-written checkpoint behind."""
    path = os.path.abspath(path)
    target = os.path.join(path, _FILE)
    if os.path.exists(target) and not overwrite:
        raise FileExistsError(f"{target} exists (pass overwrite=True)")
    os.makedirs(path, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(_to_cpu(params), tmp)
    os.replace(tmp, target)


def load_params(path: str, like: Any | None = None) -> Any:
    """Read the tree under the directory `path` (CPU tensors). With `like`,
    a tree of the expected structure, differing dict keys raise."""
    target = os.path.join(os.path.abspath(path), _FILE)
    if not os.path.exists(target):
        raise FileNotFoundError(f"no checkpoint at {target}")
    tree = torch.load(target, map_location="cpu", weights_only=True)
    if like is not None:
        _check_like(tree, like, "")
    return tree


def _check_like(tree: Any, like: Any, where: str) -> None:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise KeyError(f"checkpoint {where or 'root'}: expected keys {sorted(like)[:8]}, "
                           f"got {got[:8] if isinstance(got, list) else got}")
        for k in like:
            _check_like(tree[k], like[k], f"{where}.{k}" if where else k)
    elif isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint {where}: expected a tensor of shape "
                             f"{tuple(like.shape)}")


def load_released_checkpoint(path: str, convert_fn: Callable[[str], Any]) -> Any:
    """Checkpoint dispatch for the model CLIs (the counterpart of
    `cm3d_tpu/pipelines/masks.py load_converted`): a directory is an
    already-converted tree (`save_params`), loaded as it is; a file is the
    released torch checkpoint, converted on the fly by `convert_fn(path)`."""
    if os.path.isdir(path):
        return load_params(path)
    return convert_fn(path)
