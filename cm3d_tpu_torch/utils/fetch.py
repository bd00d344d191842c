"""Device->host transfers that do not stall the stream they leave from."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cm3d_tpu_torch.datasets.types import map_fields
from cm3d_tpu_torch.utils.observability import span


class HostCopy:
    """Device->host copy of a few tensors, started now on the current
    stream (pinned memory, non-blocking) and waited for on `get()`: the
    waiting thread blocks on an event recorded right after the copy, not on
    the work queued behind it."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.detach() for t in tensors]

    def get(self) -> List[np.ndarray]:
        with span("cm3d.d2h.wait"):
            if self.event is not None:
                self.event.synchronize()
            return [h.numpy() for h in self.host]


class TreeFetch:
    """A NamedTuple tree of tensors on its way to host numpy arrays in ONE
    device->host transfer: every leaf's bytes are packed into a single
    device buffer and its copy is started now (`HostCopy`); `get()` waits
    for it and views each leaf back with its dtype and shape."""

    def __init__(self, tree):
        self.tree = tree
        leaves = []
        map_fields(leaves.append, tree)
        with span("cm3d.d2h.start"):
            self.copy = HostCopy(
                [torch.cat([x.contiguous().reshape(-1).view(torch.uint8) for x in leaves])])

    def get(self):
        host = self.copy.get()[0]
        offset = 0

        def unpack(x):
            nonlocal offset
            nbytes = x.numel() * x.element_size()
            dtype = torch.empty((), dtype=x.dtype).numpy().dtype
            arr = host[offset:offset + nbytes].view(dtype).reshape(tuple(x.shape))
            offset += nbytes
            return arr

        return map_fields(unpack, self.tree)


def device_fetch(tree):
    """Copy a NamedTuple tree of tensors to host numpy arrays in one
    device->host transfer, and wait for it."""
    return TreeFetch(tree).get()
