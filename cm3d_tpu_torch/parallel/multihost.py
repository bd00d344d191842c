"""Multi-host input sharding, mirrors `cm3d_tpu/parallel/multihost.py`.

The only cross-host traffic this workload needs is input distribution:
scenes split across hosts, keyframes across each host's cards. Each host
lifts its stride of the scenes and writes its own output;
`pipelines/e2e.py merge_host_outputs` joins the outputs afterwards. No
collective runs between hosts.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple, TypeVar

T = TypeVar("T")


def process_index_and_count() -> Tuple[int, int]:
    """(index, count) of this process among the hosts: from torch.distributed
    when the caller has initialised it, else from the RANK / WORLD_SIZE that
    torchrun and most launchers set, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return 0, 1


def shard_for_host(
    items: Sequence[T],
    process_index: int | None = None,
    process_count: int | None = None,
) -> List[T]:
    """Deterministic strided split of a work list across hosts.

    Strided (not contiguous) so that scene-length skew balances; every host
    sees the same global ordering, which keeps resume manifests host-local.
    The defaults come from `process_index_and_count`."""
    if process_index is None or process_count is None:
        pi, pc = process_index_and_count()
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    return list(items[process_index::process_count])
