"""The device mesh over torch.distributed: the `--data_parallel N`
contract (mirrors `cm3d_tpu/parallel/mesh.py dp_mesh`) and the (data,
model) mesh of `make_mesh`.

JAX runs one controller over an N-chip mesh: one call, one output, the
same result as the single-device run. The port keeps that contract with N
processes, one a rank of the mesh:

- The calling process is rank 0, on cuda:0 (or the CPU). It spawns N-1
  workers with the "spawn" start method (a fork after CUDA's
  initialisation breaks); rank r runs on cuda:r.
- All N join the default process group: NCCL on the card, gloo on the CPU.
  They meet on a FileStore in a temporary directory, not on a TCP port,
  so that concurrent groups on one machine cannot collide.
- A mesh (`Mesh`, `make_mesh`) lays the ranks out on a grid of named axes,
  row-major as JAX's reshape of the device list (the model ranks of one
  data row are adjacent). Every rank opens one sub-group a line of each
  axis (`dist.new_group`, every rank creating every group in the same
  order; a line that spans the whole world is the default group), and a
  step reaches the line it is on by the axis's name (`axis_group`).
- The controller keeps its host loop. A data-parallel step (`run`): it posts
  a command to the file store (host memory: nothing waits for the card),
  scatters rank r the rows r*B/N ... (r+1)*B/N - 1 of every batch-major
  input (packed into one byte buffer a rank), runs its own rows, and
  gathers the outputs back in rank order, so the caller sees the tensors of
  the single-device step in the same row order. No step reads anything
  back from the card. An SPMD program (`spmd`): every rank builds it, each
  call broadcasts its inputs to every rank, every rank runs it (making
  its own collectives over the axis groups) and rank 0's output is the
  call's.
- A worker rebuilds a step from picklable arguments: its factory by
  importable name ("module:function"), called with the factory's arguments
  and `device=` the rank's device.
- The group is destroyed when the controller leaves it, so a second group
  can follow in the same process; each rank's kernel launch counts are
  summed onto rank 0's counters on the way out. A worker's exception
  reaches the controller as a raised error carrying the worker's
  traceback: before a step, when the worker has died; inside one, at once
  on gloo, which notices the closed peer; on NCCL a collective with a dead
  peer waits for the group's timeout, and PyTorch's watchdog then ends the
  process with an error. A worker whose rank 0 has gone exits.

On the CPU, what stands for a device is a core: N ranks are N processes,
so N may be at most `os.cpu_count()`. A worker takes rank 0's count of
intra-op threads.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import functools
import importlib
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch

GROUP_TIMEOUT_S = 600.0  # every collective of the group, and the start-up
_ALIGN = 16  # byte alignment of each tensor in a packed buffer
# the kernel wrappers whose `.launches` counts a worker's launches for rank 0
_LAUNCH_COUNTERS = (
    ("cm3d_tpu_torch.kernels.compact", "compact_rows"),
    ("cm3d_tpu_torch.kernels.medoid", "medoid_distance_sums_rows"),
    ("cm3d_tpu_torch.kernels.segment", "segment_sum_max"),
    ("cm3d_tpu_torch.kernels.segment", "segment_sum"),
    ("cm3d_tpu_torch.kernels.segment", "segment_sum_bwd"),
    ("cm3d_tpu_torch.kernels.window_attn", "window_attn_heads"),
    ("cm3d_tpu_torch.kernels.window_attn", "window_attn_qkv"),
    ("cm3d_tpu_torch.kernels.window_attn", "window_attn_proj"),
    ("cm3d_tpu_torch.kernels.window_attn_relpos", "window_attn_relpos_heads"),
    ("cm3d_tpu_torch.kernels.window_attn_relpos", "window_attn_relpos_proj"),
)


class Program(NamedTuple):
    """How a worker rebuilds a step: `factory(*args, device=d)`."""

    factory: str  # "package.module:function"
    args: tuple = ()


def _resolve(name: str) -> Callable:
    module, _, attr = name.partition(":")
    return getattr(importlib.import_module(module), attr)


# --- the global batch -----------------------------------------------------

_GLOBAL_BATCH = contextvars.ContextVar("cm3d_global_batch", default=False)


@contextlib.contextmanager
def global_batch():
    """Inside: each rank holds its rows of one global batch, and the
    training statistics that span the batch (BatchNorm's, the loss
    denominators) are reduced over the default process group."""
    token = _GLOBAL_BATCH.set(True)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def in_global_batch() -> bool:
    return _GLOBAL_BATCH.get()


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the default group: one all-reduce a dtype over
    the tensors flattened into one buffer (every rank gets the same bits).
    Returns new tensors; the inputs are not modified."""
    import torch.distributed as dist

    out: List[Any] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank `src`'s."""
    import torch.distributed as dist

    for t in tensors:
        dist.broadcast(t, src=src)


# --- validation and devices -------------------------------------------------

def available_devices(device: torch.device) -> int:
    """Cards for NCCL ranks, cores for gloo ranks on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def validate_data_parallel(data_parallel: int, batch_size: int, device) -> None:
    """dp_mesh's checks, with JAX's words: a clear SystemExit instead of an
    error deep inside the group's start."""
    import torch.distributed as dist

    device = torch.device(device)
    if data_parallel <= 0:
        raise SystemExit(f"--data_parallel must be positive, got {data_parallel}")
    if batch_size % data_parallel:
        raise SystemExit(f"--data_parallel {data_parallel} must divide "
                         f"--batch_size {batch_size}")
    n_avail = available_devices(device)
    if data_parallel > n_avail:
        raise SystemExit(f"--data_parallel {data_parallel} exceeds {n_avail} "
                         f"available devices")
    if dist.is_available() and dist.is_initialized():
        raise SystemExit("--data_parallel starts its own default process group, and this "
                         "process already holds one: two groups cannot both be the default")
    if device.type == "cuda" and device.index not in (None, 0):
        raise SystemExit(f"--data_parallel runs rank r on cuda:r, so rank 0 (this process) "
                         f"must be on cuda:0, not {device}")


def rank_device(device_type: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")


# --- the mesh -----------------------------------------------------------------

def default_devices() -> List[torch.device]:
    """The cards, or with none a CPU core each (a core stands for a device)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


class Mesh:
    """A grid of ranks with named axes: `shape` maps each axis name to its
    size, in order; rank r sits at the row-major coordinates of r (JAX's
    reshape of the device list) and runs on cuda:r (or a CPU core). A
    description only: a `DataParallelGroup` started with it runs its ranks."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = 1
        for s in self.shape.values():
            self.size *= s

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def rank(self, coords: dict) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def axis_lines(self, name: str) -> List[Tuple[int, ...]]:
        """The ranks along axis `name`, one tuple a position of the other
        axes, in rank order."""
        others = [n for n in self.axis_names if n != name]
        lines = []
        for pos in itertools.product(*(range(self.shape[n]) for n in others)):
            fixed = dict(zip(others, pos))
            lines.append(tuple(self.rank({**fixed, name: i}) for i in range(self.shape[name])))
        return lines


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh, mirrors `cm3d_tpu/parallel/mesh.py make_mesh`:
    all devices on the data axis by default, JAX's ValueErrors in JAX's
    words."""
    if devices is None:
        devices = default_devices()
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data <= 0 or n_model <= 0:
        raise ValueError(f"mesh axes must be positive, got data={n_data} model={n_model}")
    if n_data * n_model > len(devices):
        raise ValueError(f"mesh ({n_data} data x {n_model} model) exceeds "
                         f"{len(devices)} available devices")
    return Mesh(("data", "model"), (n_data, n_model))


class AxisGroup(NamedTuple):
    """This rank's line of one mesh axis: its process group, this rank's
    index on the line, the line's size and its global ranks."""

    group: Any
    index: int
    size: int
    ranks: Tuple[int, ...]


_AXES: dict = {}  # axis name -> AxisGroup, while this process is a rank of a mesh
_MESH: list = []  # [the Mesh], likewise


def axis_group(name: str) -> AxisGroup:
    """This rank's line of mesh axis `name` (inside a step of a started
    group)."""
    if name not in _AXES:
        raise ValueError(f"no running mesh has a {name!r} axis here "
                         f"(axes: {sorted(_AXES) or 'none'})")
    return _AXES[name]


def running_mesh() -> Mesh:
    """The Mesh of the group this process is a rank of."""
    if not _MESH:
        raise ValueError("this process is no rank of a started mesh group")
    return _MESH[0]


def _open_axis_groups(mesh: Mesh, rank: int) -> None:
    """Every rank runs this in the same order, right after joining the
    default group: one group a line of each axis."""
    import torch.distributed as dist

    _AXES.clear()
    for name in mesh.axis_names:
        for line in mesh.axis_lines(name):
            group = dist.group.WORLD if len(line) == mesh.size else dist.new_group(list(line))
            if rank in line:
                _AXES[name] = AxisGroup(group, line.index(rank), len(line), line)
    _MESH[:] = [mesh]


def _close_axis_groups() -> None:
    _AXES.clear()
    _MESH.clear()


def gather_to_first(tensors: Sequence[torch.Tensor], axis: str):
    """Gather each rank's `tensors` (the same shapes and dtypes on every rank
    of the line) to the first rank of its line of `axis`: there, a list a
    rank in line order of lists of tensors; elsewhere None."""
    import torch.distributed as dist

    ax = axis_group(axis)
    specs = [(tuple(t.shape), t.dtype) for t in tensors]
    device = tensors[0].device if tensors else torch.device("cpu")
    buf = _pack(tensors, device)
    bufs = [torch.empty_like(buf) for _ in range(ax.size)] if ax.index == 0 else None
    dist.gather(buf, bufs, dst=ax.ranks[0], group=ax.group)
    return None if bufs is None else [_unpack(b, specs) for b in bufs]


# --- trees of tensors, packed into byte buffers -----------------------------

class _Leaf:
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_Leaf, (self.i,))

    def __eq__(self, other):
        return isinstance(other, _Leaf) and other.i == self.i

    def __hash__(self):
        return hash(self.i)


def _flatten(tree):
    """(skeleton, tensors): the skeleton is the tree with each tensor
    replaced by its index; anything else rides in the skeleton as is."""
    leaves: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return _Leaf(len(leaves) - 1)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree), leaves


def _unflatten(skeleton, leaves):
    def walk(x):
        if isinstance(x, _Leaf):
            return leaves[x.i]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(skeleton)


def _spec_bytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    return nbytes + (-nbytes) % _ALIGN


@torch.no_grad()
def _pack(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    parts = []
    for t in tensors:
        b = t.detach().to(device).contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = (-b.numel()) % _ALIGN
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=device))
    buf = torch.cat(parts) if parts else None
    if buf is None or not buf.numel():
        return torch.zeros(_ALIGN, dtype=torch.uint8, device=device)
    return buf


def _unpack(buf: torch.Tensor, specs) -> list:
    out, off = [], 0
    for shape, dtype in specs:
        n = 1
        for s in shape:
            n *= s
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        out.append(buf[off: off + nbytes].view(dtype).reshape(shape))
        off += _spec_bytes(shape, dtype)
    return out


def _packed_bytes(specs) -> int:
    return max(_ALIGN, sum(_spec_bytes(s, d) for s, d in specs))


def shard_batch(batch, rank: int, world: int):
    """Rank `rank`'s rows of a batch-major tree (NamedTuples, tuples,
    dicts of tensors whose leading dim is the global batch B): rows
    rank*B/world ... (rank+1)*B/world - 1 of every tensor."""
    skeleton, leaves = _flatten(batch)
    if not leaves:
        return batch
    b = _rows_per_rank(leaves, world)
    return _unflatten(skeleton, [t[rank * b:(rank + 1) * b] for t in leaves])


def _rows_per_rank(leaves, world: int) -> int:
    size = leaves[0].shape[0] if leaves[0].ndim else None
    if size is None or any(t.ndim == 0 or t.shape[0] != size for t in leaves):
        raise ValueError("every tensor of a data-parallel batch needs the same leading "
                         f"(batch) dim; got {[tuple(t.shape) for t in leaves]}")
    if size % world:
        raise ValueError(f"a batch of {size} rows does not split over {world} ranks")
    return size // world


# --- the group ----------------------------------------------------------------

def launch_counts() -> dict:
    out = {}
    for module, name in _LAUNCH_COUNTERS:
        out[name] = getattr(importlib.import_module(module), name).launches
    return out


def _add_launch_counts(counts: dict) -> None:
    for module, name in _LAUNCH_COUNTERS:
        getattr(importlib.import_module(module), name).launches += counts.get(name, 0)


class _Commands:
    """Rank 0's commands to the workers, through the group's file store:
    host memory only, so that sending one never waits for the card (an
    object collective would copy through the device). A step whose tree
    and shapes are those of the step before sends one byte."""

    def __init__(self, store):
        self.store, self.seq, self.last = store, 0, None

    def send(self, cmd) -> None:
        blob = b"=" if cmd == self.last else pickle.dumps(cmd)
        self.store.set(f"cmd/{self.seq}", blob)
        self.seq += 1
        self.last = cmd

    def recv(self, parent_pid: int):
        key = f"cmd/{self.seq}"
        while True:
            try:
                self.store.wait([key], datetime.timedelta(seconds=5))
                break
            except RuntimeError:
                if os.getppid() != parent_pid:  # rank 0 is gone
                    os._exit(1)
        blob = self.store.get(key)
        self.seq += 1
        if blob != b"=":
            self.last = pickle.loads(blob)
        return self.last


class DataParallelGroup:
    """Rank 0 of an N-rank group, as a context manager (see the module
    docstring): `world` is N (a one-axis "data" mesh) or a `Mesh`. With a
    `program`, every worker builds it at the start and `run(fn, args)` is
    one data-parallel step; a worker whose step has a `sync` calls it once,
    right after building it, and rank 0's caller makes the matching
    collective calls right after entering (run_pretrain broadcasts its train
    state so). `spmd(program)` builds an SPMD program on every rank."""

    def __init__(self, world, device, program: Program | None = None):
        self.mesh = world if isinstance(world, Mesh) else Mesh(("data",), (world,))
        self.world = self.mesh.size
        self.device = torch.device(device)
        self.program = program
        self.backend = "nccl" if self.device.type == "cuda" else "gloo"
        self._procs: list = []
        self._tmp = None
        self._keys = itertools.count()

    # -- start and teardown --------------------------------------------------

    def __enter__(self) -> "DataParallelGroup":
        import multiprocessing

        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            raise RuntimeError("a mesh group starts its own default process group, and this "
                               "process already holds one: two groups cannot both be the default")
        if self.device.type == "cuda":
            if self.device.index not in (None, 0):
                raise ValueError(f"a mesh group runs rank r on cuda:r, so rank 0 (this "
                                 f"process) must be on cuda:0, not {self.device}")
            # one nvcc run here, not one in each worker
            from cm3d_tpu_torch.kernels.build import build_all

            build_all()
            torch.cuda.set_device(0)
        self._tmp = tempfile.mkdtemp(prefix="cm3d_dp_")
        ctx = multiprocessing.get_context("spawn")
        try:
            for rank in range(1, self.world):
                proc = ctx.Process(target=_worker_main, daemon=True,
                                   args=(rank, self.mesh, self._tmp, self.device.type,
                                         self.program, os.getpid(), torch.get_num_threads()))
                proc.start()
                self._procs.append(proc)
            store = dist.FileStore(os.path.join(self._tmp, "store"), self.world)
            self._wait_ready(store)
            self._commands = _Commands(store)
            dist.init_process_group(self.backend, store=store, rank=0, world_size=self.world,
                                    timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
            _open_axis_groups(self.mesh, 0)
        except BaseException:
            self._teardown(failed=True)
            raise
        return self

    def _check_workers(self) -> None:
        """Raise with a worker's traceback if one has died (checked before
        each step: on NCCL a collective with a dead peer would wait until
        the group's timeout, and then PyTorch's watchdog ends the process)."""
        dead = [p for p in self._procs if not p.is_alive()]
        if dead:
            for p in dead:
                p.join()
            raise RuntimeError(self._failure_text() or "a data-parallel worker exited with "
                               f"code {dead[0].exitcode}")

    def _wait_ready(self, store) -> None:
        """Wait for each worker to reach the group, watching that it is
        still alive (one that dies on its way must not leave rank 0 waiting
        in the group's start)."""
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        for rank, proc in enumerate(self._procs, start=1):
            while True:
                try:
                    store.wait([f"ready/{rank}"], datetime.timedelta(seconds=1))
                    break
                except RuntimeError:
                    if not proc.is_alive():
                        proc.join()
                        raise RuntimeError(self._failure_text()
                                           or f"data-parallel rank {rank} exited "
                                           f"with code {proc.exitcode} before it joined")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"data-parallel rank {rank} did not start "
                                           f"within {GROUP_TIMEOUT_S:.0f} s")

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._teardown(failed=True)
            return False
        try:
            import torch.distributed as dist

            self._commands.send(("stop",))
            counts: list = [None] * self.world
            dist.gather_object(launch_counts(), counts, dst=0)
            for c in counts[1:]:
                _add_launch_counts(c)
        except BaseException as e:
            self._teardown(failed=True)
            raise self._worker_error(e) from e
        self._teardown(failed=False)
        return False

    def _teardown(self, failed: bool) -> None:
        import torch.distributed as dist

        try:
            _close_axis_groups()
            if dist.is_initialized():
                dist.destroy_process_group()
        finally:
            for proc in self._procs:
                proc.join(timeout=1.0 if failed else 60.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            self._failure = self._failure_text()
            if self._tmp is not None:
                shutil.rmtree(self._tmp, ignore_errors=True)
                self._tmp = None

    def _failure_text(self) -> str:
        if self._tmp is None:
            return getattr(self, "_failure", "")
        texts = []
        for rank in range(1, self.world):
            path = os.path.join(self._tmp, f"rank{rank}.err")
            if os.path.exists(path):
                with open(path) as f:
                    texts.append(f"data-parallel rank {rank} failed:\n{f.read()}")
        return "\n".join(texts)

    def _worker_error(self, e: BaseException) -> BaseException:
        """The workers' tracebacks, when a collective failed because a
        worker did (given a few seconds to show); else `e` itself."""
        deadline = time.monotonic() + 5.0
        while all(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            time.sleep(0.05)
        for proc in self._procs:
            if not proc.is_alive():
                proc.join()
        text = self._failure_text()
        return RuntimeError(text) if text else e

    # -- a step ----------------------------------------------------------------

    def run(self, fn: Callable, args: tuple, gather: bool = True):
        """One step: scatter the rows of `args` (a batch-major tree), call
        `fn(*rank 0's rows)` here while each worker runs its step on its
        rows, and with `gather` return the outputs of every rank
        concatenated along dim 0 in rank order (else `fn`'s own output)."""
        import torch.distributed as dist

        skeleton, leaves = _flatten(tuple(args))
        b = _rows_per_rank(leaves, self.world)
        specs = [((b,) + tuple(t.shape[1:]), t.dtype) for t in leaves]
        try:
            self._check_workers()
            self._commands.send(("step", skeleton, specs, gather))
            chunks = [_pack([t[r * b:(r + 1) * b] for t in leaves], self.device)
                      for r in range(self.world)]
            recv = torch.empty_like(chunks[0])
            dist.scatter(recv, chunks, src=0)
            del chunks
            out = fn(*_unflatten(skeleton, _unpack(recv, specs)))
            if not gather:
                return out
            return _gather_rows(out, self.world, self.device)
        except Exception as e:
            err = self._worker_error(e)
            if err is e:
                raise
            raise err from e

    def spmd(self, program: Program, local: Callable | None = None) -> Callable:
        """Build `program` on every rank (here too, unless `local` is rank
        0's instance already built) and return `call(*args)`: one SPMD step,
        `args` (a tree of tensors and picklable values) broadcast to every
        rank, each rank calling its instance with them (rank 0 with the
        caller's own tensors), rank 0's output returned. The instances make
        their own collectives, over the axis groups (`axis_group`)."""
        key = next(self._keys)
        self._guard(lambda: self._commands.send(("build", key, program)))
        fn = local if local is not None else _resolve(program.factory)(*program.args,
                                                                        device=self.device)
        return functools.partial(self._call, key, fn)

    def _call(self, key: int, fn: Callable, *args):
        import torch.distributed as dist

        def step():
            skeleton, leaves = _flatten(tuple(args))
            specs = [(tuple(t.shape), t.dtype) for t in leaves]
            self._check_workers()
            self._commands.send(("call", key, skeleton, specs))
            dist.broadcast(_pack(leaves, self.device), src=0)
            return fn(*args)

        return self._guard(step)

    def _guard(self, step: Callable):
        """`step()`, a worker's traceback raised in place of the error a
        collective with a failed worker gives."""
        try:
            return step()
        except Exception as e:
            err = self._worker_error(e)
            if err is e:
                raise
            raise err from e


def _gather_rows(out, world: int, device: torch.device):
    import torch.distributed as dist

    skeleton, leaves = _flatten(out)
    buf = _pack(leaves, device)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.gather(buf, bufs, dst=0)
    specs = [(tuple(t.shape), t.dtype) for t in leaves]
    per_rank = [_unpack(x, specs) for x in bufs]
    return _unflatten(skeleton, [torch.cat([p[i] for p in per_rank])
                                 for i in range(len(leaves))])


def dp_mesh(data_parallel: int, batch_size: int, device, program: Program) -> DataParallelGroup:
    """The CLIs' --data_parallel contract in one place: validate N against
    the batch and the device count, then the (not yet started) N-rank group
    whose workers rebuild their step from `program`."""
    validate_data_parallel(data_parallel, batch_size, device)
    return DataParallelGroup(data_parallel, device, program)


# --- the worker side ------------------------------------------------------------

def _worker_main(rank: int, mesh: Mesh, tmp: str, device_type: str,
                 program: Program | None, parent_pid: int, n_threads: int) -> None:
    """A spawned rank: join the group and its axis groups, build the step
    if the group has one (a factory may make collective calls, e.g. an
    `axis_name` train step checks the group), run its `sync` if it has one
    (rank 0's caller makes the matching calls), then serve rank 0's
    commands until it says stop: data-parallel steps, and the SPMD
    programs' builds and calls. Any exception is written where rank 0 reads
    it, and the process exits non-zero."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(n_threads)
        world = mesh.size
        device = rank_device(device_type, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        store.set(f"ready/{rank}", "1")
        commands = _Commands(store)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        _open_axis_groups(mesh, rank)
        fn = None
        if program is not None:
            fn = _resolve(program.factory)(*program.args, device=device)
            sync = getattr(fn, "sync", None)
            if sync is not None:
                sync()
        programs: dict = {}
        while True:
            cmd = commands.recv(parent_pid)
            if cmd[0] == "stop":
                break
            if cmd[0] == "build":
                _, key, prog = cmd
                programs[key] = _resolve(prog.factory)(*prog.args, device=device)
                continue
            if cmd[0] == "call":
                _, key, skeleton, specs = cmd
                buf = torch.empty(_packed_bytes(specs), dtype=torch.uint8, device=device)
                dist.broadcast(buf, src=0)
                programs[key](*_unflatten(skeleton, _unpack(buf, specs)))
                continue
            _, skeleton, specs, gather = cmd
            recv = torch.empty(_packed_bytes(specs), dtype=torch.uint8, device=device)
            dist.scatter(recv, None, src=0)
            out = fn(*_unflatten(skeleton, _unpack(recv, specs)))
            if gather:
                _, leaves = _flatten(out)
                dist.gather(_pack(leaves, device), None, dst=0)
        dist.gather_object(launch_counts(), None, dst=0)
        _close_axis_groups()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
