"""GPipe-style pipeline parallelism over a `stage` mesh axis. Mirrors
`cm3d_tpu/parallel/gpipe.py`.

The workload's models all fit one card, so the package does not NEED
pipeline parallelism: this module completes the parallelism toolkit for
stacks that outgrow one card. The recipe is JAX's:

  - the layer stack's parameters stacked on a leading stage axis
    (`stack_layer_params`), rank s holding stage s's slice;
  - activations flow stage -> stage + 1, one send / recv pair a tick;
  - the fill-drain schedule over M + S - 1 ticks: stage 0 ingests
    microbatch t at tick t, stage s runs microbatch t - s, the last stage
    retires microbatch t - (S - 1).

JAX runs the schedule inside one shard_map; here rank 0 drives it through
its mesh group (`parallel/mesh.py`): `run(stage_params, x)` is a
`torch.autograd.Function` on rank 0 whose forward makes every rank run the
forward schedule (each keeping its microbatches' activations) and whose
backward sends the output's gradient back through the stages in reverse,
so `(run(sp, x) ** 2).sum().backward()` gives the stacked parameters' and
x's gradients on rank 0, as grad(pipeline_apply) does in JAX.

dp x pp runs on a (data, stage) grid: dim 1 of x splits over the data
rows, the parameters replicate across rows, and the stage parameters'
gradients are summed over the data axis.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from cm3d_tpu_torch.parallel.mesh import (
    DataParallelGroup, Mesh, Program, axis_group, default_devices, running_mesh)


def stage_mesh(n_stages: int, devices=None, n_data: int = 1) -> Mesh:
    """A pipeline mesh with a `stage` axis; `n_data > 1` gives the 2-D
    (data, stage) mesh for dp x pp, the stages of one data row adjacent."""
    if devices is None:
        devices = default_devices()
    need = n_stages * n_data
    if n_stages < 1 or n_data < 1 or need > len(devices):
        raise ValueError(f"need n_stages*n_data in 1..{len(devices)}, got "
                         f"{n_stages}*{n_data}")
    if n_data == 1:
        return Mesh(("stage",), (n_stages,))
    return Mesh(("data", "stage"), (n_data, n_stages))


def stack_layer_params(layer_params: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack state dicts with identical keys [p_0 .. p_{L-1}] into one dict
    whose tensors carry a leading layer axis: the pipeline's layout."""
    keys = list(layer_params[0])
    if any(list(p) != keys for p in layer_params):
        raise ValueError("stack_layer_params needs state dicts with identical keys")
    return {k: torch.stack([p[k] for p in layer_params]) for k in keys}


def make_pipeline_fn(mesh: DataParallelGroup, stage_fn: Callable, axis: str = "stage",
                     batch_axis: str | None = None):
    """Build `run(stage_params, x) -> y` over the started group `mesh`,
    whose Mesh has the axis `axis` (and `batch_axis`, if given).

    stage_fn(params_slice, x_mb) -> y_mb applies ONE stage (for example a
    block's `torch.func.functional_call` over the stage's own layer
    sub-stack); every rank builds the pipeline from it, so it must pickle
    (a module-level function, or a partial of one). stage_params: a dict
    whose every tensor has leading dim S = the axis's size. x: [M, ...]
    microbatch-major inputs; stage_fn keeps the shape. Returns y [M, ...]
    with y[m] = stage_{S-1}(... stage_0(x[m])) on rank 0.

    `batch_axis` composes the pipeline with data parallelism on a 2-D mesh
    (stage_mesh(n_data=...)): dim 1 of each microbatch splits over that
    axis, every data row runs the same schedule on its share, and the
    parameters' gradients are summed over the rows."""
    shape = mesh.mesh.shape
    if axis not in shape:
        raise ValueError(f"mesh has no {axis!r} axis: {shape}")
    if batch_axis is not None and batch_axis not in shape:
        raise ValueError(f"mesh has no {batch_axis!r} axis: {shape}")
    s = shape[axis]
    call = mesh.spmd(Program(f"{__name__}:_PipelineRank", (stage_fn, axis, batch_axis)))

    class _Run(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, keys, train, *params):
            ctx.keys = keys
            return call("forward", dict(zip(keys, params)), x, train)

        @staticmethod
        def backward(ctx, grad_y):
            grad_x, grads = call("backward", grad_y.contiguous())
            return (grad_x, None, None, *(grads[k] for k in ctx.keys))

    def run(stage_params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        lead = {None if t.ndim == 0 else t.shape[0] for t in stage_params.values()}
        if lead != {s}:
            raise ValueError(f"stage_params leading dims {lead} != mesh {axis}={s} — "
                             "every tensor needs a stacked stage axis (stack_layer_params)")
        if batch_axis:
            n_data = shape[batch_axis]
            if x.ndim < 2:
                raise ValueError(f"batch_axis={batch_axis!r} needs x of rank >= 2 "
                                 f"([microbatch, data_rows, ...]); got shape {tuple(x.shape)}")
            if x.shape[1] % n_data:
                raise ValueError(f"x dim 1 ({x.shape[1]}) must divide evenly over mesh "
                                 f"{batch_axis!r}={n_data}")
        keys = tuple(sorted(stage_params))
        params = [stage_params[k] for k in keys]
        # the ranks keep their activations only for a backward to come
        train = torch.is_grad_enabled() and any(t.requires_grad for t in [x, *params])
        return _Run.apply(x, keys, train, *params)

    return run


class _PipelineRank:
    """One rank's part of the schedule: stage `index` of its line of the
    stage axis, on its data row's share of the batch."""

    def __init__(self, stage_fn: Callable, axis: str, batch_axis: str | None, device):
        self.stage_fn, self.axis, self.batch_axis = stage_fn, axis, batch_axis
        self.device = torch.device(device)
        self.saved: list = []  # (input, output) a microbatch, for the backward

    def __call__(self, op: str, *args):  # "forward" or "backward"
        return getattr(self, op)(*args)

    def _lines(self):
        st = axis_group(self.axis)
        data = axis_group(self.batch_axis) if self.batch_axis else None
        return st, data

    def _rows(self, t: torch.Tensor, data) -> torch.Tensor:
        """This data row's share of dim 1."""
        if data is None:
            return t
        b = t.shape[1] // data.size
        return t[:, data.index * b:(data.index + 1) * b]

    def forward(self, stage_params: dict, x: torch.Tensor, train: bool):
        import torch.distributed as dist

        st, data = self._lines()
        s, n = st.index, st.size
        x = self._rows(x.to(self.device), data)
        self.params = {k: v[s].detach().to(self.device).requires_grad_(train)
                       for k, v in stage_params.items()}
        m = x.shape[0]
        self.saved = []
        ys = []
        for t in range(m + n - 1):
            mb = t - s
            if not 0 <= mb < m:
                continue  # this stage's fill or drain tick
            if s == 0:
                inp = x[mb].detach()
            else:
                inp = torch.empty_like(x[0])
                dist.recv(inp, src=st.ranks[s - 1])
            inp.requires_grad_(train)
            with torch.set_grad_enabled(train):
                out = self.stage_fn(self.params, inp)
            if train:
                self.saved.append((inp, out))
            if s < n - 1:
                dist.send(out.detach().contiguous(), dst=st.ranks[s + 1])
            else:
                ys.append(out.detach())
        return self._to_first(torch.stack(ys) if ys else None, st, data, x)

    def _to_first(self, y, st, data, x):
        """The last stages' outputs, concatenated over the data rows on
        rank 0 (the first rank of the first data row)."""
        import torch.distributed as dist

        me = dist.get_rank()
        lasts = [st.ranks[-1]] if data is None else [
            running_mesh().rank({self.batch_axis: d, self.axis: st.size - 1})
            for d in range(data.size)]
        if me == 0:
            parts = []
            for r in lasts:
                if r == 0:
                    parts.append(y)
                else:
                    buf = torch.empty_like(x)
                    dist.recv(buf, src=r)
                    parts.append(buf)
            return torch.cat(parts, dim=1) if data is not None else parts[0]
        if me in lasts:
            dist.send(y.contiguous(), dst=0)
        return None

    def backward(self, grad_y: torch.Tensor):
        import torch.distributed as dist

        st, data = self._lines()
        s, n = st.index, st.size
        grad_y = self._rows(grad_y.to(self.device), data)
        m = grad_y.shape[0]
        grad_x = [None] * m
        for mb in reversed(range(m)):
            inp, out = self.saved[mb]
            if s == n - 1:
                g = grad_y[mb]
            else:
                g = torch.empty_like(out)
                dist.recv(g, src=st.ranks[s + 1])
            torch.autograd.backward(out, g)
            if s > 0:
                dist.send(inp.grad.contiguous(), dst=st.ranks[s - 1])
            else:
                grad_x[mb] = inp.grad
        self.saved = []
        keys = sorted(self.params)
        grads = [self.params[k].grad if self.params[k].grad is not None
                 else torch.zeros_like(self.params[k]) for k in keys]
        if data is not None:  # the dp gradient sync
            for g in grads:
                dist.all_reduce(g, group=data.group)
        return self._grads_to_first(keys, grads, grad_x, st, data)

    def _grads_to_first(self, keys, grads, grad_x, st, data):
        """Rank 0 gathers each stage's gradients (from the first data row)
        into the stacked layout, and x's gradient (from every row's first
        stage) along dim 1."""
        import torch.distributed as dist

        me = dist.get_rank()
        row0 = data is None or data.index == 0
        if me != 0:
            if row0:
                for g in grads:
                    dist.send(g.contiguous(), dst=0)
            if st.index == 0:
                dist.send(torch.stack(grad_x).contiguous(), dst=0)
            return None
        stacked = {k: [g] for k, g in zip(keys, grads)}
        for r in st.ranks[1:]:
            for k, g in zip(keys, grads):
                buf = torch.empty_like(g)
                dist.recv(buf, src=r)
                stacked[k].append(buf)
        gx = [torch.stack(grad_x)]
        if data is not None:
            mesh = running_mesh()
            for d in range(1, data.size):
                buf = torch.empty_like(gx[0])
                dist.recv(buf, src=mesh.rank({self.batch_axis: d, self.axis: 0}))
                gx.append(buf)
        return torch.cat(gx, dim=1), {k: torch.stack(v) for k, v in stacked.items()}
