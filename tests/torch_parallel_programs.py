"""SPMD programs and builders that the port's model-parallel tests run on
every rank of a gloo mesh group (tests/test_torch_model_parallel.py,
tests/test_torch_gpipe.py). A worker imports this module by name, so it
imports only the port."""

import dataclasses

import torch
from torch.func import functional_call

from cm3d_tpu_torch.models.clip_text import ResidualAttentionBlock
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
from cm3d_tpu_torch.models.sam import SAM_TEST, Sam
from cm3d_tpu_torch.parallel.mesh import running_mesh
from cm3d_tpu_torch.parallel.sharding import make_sequence_sharded_encode, shard_model_params
from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES


def sam_module(sd: dict, quant: bool = False) -> Sam:
    """SAM_TEST (its int8 twin with `quant`) holding the state dict `sd`."""
    sam = Sam(dataclasses.replace(SAM_TEST, quant_int8=quant))
    sam.load_state_dict(sd)
    return sam.eval().requires_grad_(False)


def detic_module(sd: dict) -> Detic:
    detic = Detic(DETIC_TEST)
    detic.load_state_dict(sd)
    return detic.eval().requires_grad_(False)


def sharded_sam(sd: dict, quant: bool, device):
    """SAM's box-prompted forward (encode, then decode; JAX's Sam.__call__)
    with its layers tensor-sharded over the mesh's model axis."""
    sam = shard_model_params(sam_module(sd, quant), running_mesh())

    @torch.inference_mode()
    def forward(image, boxes):
        return sam.decode_boxes(sam.encode_image(image[None])[0], boxes)

    forward.module = sam
    return forward


def sharded_detic(sd: dict, device):
    """DETIC_TEST's forward tensor-sharded over the model axis."""
    detic = shard_model_params(detic_module(sd), running_mesh())

    @torch.inference_mode()
    def forward(images, classifier, hw):
        return tuple(detic(images, classifier, hw))

    return forward


def sharded_clip(sd: dict, device):
    """CLIP_TEXT_TEST's text tower tensor-sharded over the model axis (the
    fused in_proj by heads, out_proj / c_proj row-parallel)."""
    from cm3d_tpu_torch.models.clip_text import CLIP_TEXT_TEST, ClipTextEncoder

    clip = ClipTextEncoder(CLIP_TEXT_TEST)
    clip.load_state_dict(sd)
    clip = shard_model_params(clip.eval().requires_grad_(False), running_mesh())
    return torch.inference_mode()(clip)


def sequence_sharded_encode(sd: dict, quant: bool, device):
    return make_sequence_sharded_encode(running_mesh(), sam_module(sd, quant))


def mask_models(detic_sd: dict, sam_sd: dict, classifier, quant_int8: bool = False,
                quant_static: bool = False, device=None):
    """Single-device MaskModels on carried DETIC_TEST / SAM_TEST weights
    (the camera-parallel stage's builder in the tests)."""
    from cm3d_tpu_torch.pipelines.masks import _batched_model_fns, quantized_models

    detic, sam = quantized_models(detic_module(detic_sd), sam_module(sam_sd), quant_int8,
                                  quant_static)
    return _batched_model_fns(detic, classifier, sam, CUSTOM_VOCABULARY_NUSCENES,
                              device=device)


def clip_block_stage(width: int, heads: int, ctx: int, params: dict, x: torch.Tensor):
    """One pipeline stage: CLIP's ResidualAttentionBlock applied over the
    stage's own layer sub-stack ([layers, ...] tensors) with a causal mask."""
    with torch.device("meta"):  # its parameters are the stage's
        block = ResidualAttentionBlock(width, heads)
    mask = torch.full((ctx, ctx), -torch.inf, device=x.device).triu(1)
    # one unbind a tensor: its backward stacks the layers' gradients once,
    # where an index a layer would write a stack-sized gradient each
    layers = zip(*(v.unbind(0) for v in params.values()))
    for layer in layers:
        x = functional_call(block, dict(zip(params, layer)), (x, mask))
    return x


class MeshGroups:
    """One started gloo mesh group at a time for a test module (two groups
    cannot both be the default in one process): `groups(mesh)` returns the
    running group if it runs `mesh`'s shape, else closes it and starts one;
    `close()` ends it."""

    def __init__(self):
        self.shape, self.group = None, None

    def __call__(self, mesh):
        from cm3d_tpu_torch.parallel.mesh import DataParallelGroup

        if mesh.shape != self.shape:
            self.close()
            self.group = DataParallelGroup(mesh, "cpu").__enter__()
            self.shape = mesh.shape
        return self.group

    def close(self):
        if self.group is not None:
            group, self.group, self.shape = self.group, None, None
            group.__exit__(None, None, None)


def mesh_groups():
    """A module fixture's body: MeshGroups, with this process (and so each
    worker, which takes rank 0's count) on one intra-op thread: the
    single-process runs the ranks are held to then block their products
    as the ranks do, and the suite's workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    groups = MeshGroups()
    try:
        yield groups
    finally:
        groups.close()
        torch.set_num_threads(n)
