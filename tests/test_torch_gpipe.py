"""Pipeline parallelism in the port (`cm3d_tpu_torch/parallel/gpipe.py`) on
gloo ranks on the CPU: tests/test_gpipe.py's scenarios against the JAX
package's sequential apply and its gradients, at that file's tolerances
(forward rtol / atol 2e-5; loss rtol 1e-5; gradients rtol 2e-4, atol
2e-5).

The layer stack is CLIP's ResidualAttentionBlock at JAX's test width; the
port's blocks draw their weights (`init_clip_weights`) and
`convert_clip_text_params` carries them into the JAX blocks. A stage applies its own layer sub-stack with
`torch.func.functional_call` (tests/torch_parallel_programs.py). The
groups are shared between cases, one at a time.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models.clip_text import ResidualAttentionBlock as JaxBlock
from cm3d_tpu.models.clip_text import convert_clip_text_params

from cm3d_tpu_torch.models.clip_text import CLIP_TEXT_TEST, ClipTextEncoder, init_clip_weights
from cm3d_tpu_torch.parallel import make_pipeline_fn, stack_layer_params, stage_mesh
from torch_parallel_programs import clip_block_stage, mesh_groups

WIDTH, HEADS, CTX = 16, 2, 8
CPUS = [torch.device("cpu")] * 4
STAGE = functools.partial(clip_block_stage, WIDTH, HEADS, CTX)

groups = pytest.fixture(scope="module")(mesh_groups)


def _layers(n_layers: int, seed: int):
    """Per-layer state dicts of the port's blocks and the same weights as
    JAX block params."""
    cfg = dataclasses.replace(CLIP_TEXT_TEST, width=WIDTH, heads=HEADS, layers=n_layers,
                              context_length=CTX)
    model = init_clip_weights(ClipTextEncoder(cfg), torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    layers = [{k[len(f"transformer.resblocks.{i}."):]: v.clone() for k, v in sd.items()
               if k.startswith(f"transformer.resblocks.{i}.")} for i in range(n_layers)]
    jax_params = convert_clip_text_params({k: v.numpy() for k, v in sd.items()}, cfg)
    return layers, [jax_params[f"block{i}"] for i in range(n_layers)]


def _stacked(layers, n_stages):
    lps = len(layers) // n_stages
    return stack_layer_params([stack_layer_params(layers[i * lps:(i + 1) * lps])
                               for i in range(n_stages)])


def _jax_sequential(params, x):
    block = JaxBlock(WIDTH, HEADS)
    mask = jnp.triu(jnp.full((CTX, CTX), -jnp.inf), k=1)
    for p in params:
        x = block.apply({"params": p}, x, mask)
    return x


def _jax_loss_and_grads(params, x):
    def loss(ps):
        y = jnp.stack([_jax_sequential(ps, xi) for xi in x])
        return jnp.sum(y * y)

    return jax.jit(jax.value_and_grad(loss))(params)


def _jax_grads_as_port(grads):
    """JAX block gradients in the port's per-layer state-dict layout."""
    out = []
    for g in grads:
        g = jax.tree.map(np.asarray, g)
        out.append({
            "ln_1.weight": g["ln_1"]["scale"], "ln_1.bias": g["ln_1"]["bias"],
            "attn.in_proj_weight": g["in_proj"]["kernel"].T,
            "attn.in_proj_bias": g["in_proj"]["bias"],
            "attn.out_proj.weight": g["out_proj"]["kernel"].T,
            "attn.out_proj.bias": g["out_proj"]["bias"],
            "ln_2.weight": g["ln_2"]["scale"], "ln_2.bias": g["ln_2"]["bias"],
            "mlp.c_fc.weight": g["mlp_fc"]["kernel"].T, "mlp.c_fc.bias": g["mlp_fc"]["bias"],
            "mlp.c_proj.weight": g["mlp_proj"]["kernel"].T,
            "mlp.c_proj.bias": g["mlp_proj"]["bias"],
        })
    return out


def _port_sequential(layers, x):
    """The port's blocks applied in order (the single-device run)."""
    from cm3d_tpu_torch.models.clip_text import ResidualAttentionBlock

    block = ResidualAttentionBlock(WIDTH, HEADS)
    mask = torch.full((CTX, CTX), -torch.inf).triu(1)
    for p in layers:
        x = torch.func.functional_call(block, p, (x, mask))
    return x


def _check_grads(stacked, layers, x, jax_grads, n_stages):
    """The pipeline's gradients against the port's sequential ones at
    JAX's tolerances (a re-scheduling: the same products a microbatch), and
    against JAX's within 1e-5 of each tensor's largest gradient (the
    envelope of the port's unsharded products against JAX's,
    tests/test_torch_sam.py: the sums of gradients of about 50 round
    differently in the two)."""
    leaves = [{k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
              for p in layers]
    (torch.stack([_port_sequential(leaves, xi) for xi in x]) ** 2).sum().backward()
    own = _stacked([{k: v.grad for k, v in p.items()} for p in leaves], n_stages)
    want = _stacked([{k: torch.from_numpy(np.array(v)) for k, v in g.items()}
                     for g in _jax_grads_as_port(jax_grads)], n_stages)
    assert set(stacked) == set(want) == set(own)
    for k, p in stacked.items():
        got = p.grad.numpy()
        np.testing.assert_allclose(got, own[k].numpy(), rtol=2e-4, atol=2e-5, err_msg=k)
        assert np.abs(got - want[k].numpy()).max() <= 1e-5 * np.abs(want[k].numpy()).max(), k


# (4, 4, 5) first: the cases of one mesh run next to each other (one group each)
@pytest.mark.parametrize("n_stages,n_layers,n_micro", [(4, 4, 5), (2, 4, 3)])
def test_pipeline_matches_sequential(groups, n_stages, n_layers, n_micro):
    layers, jax_params = _layers(n_layers, seed=0)
    run = make_pipeline_fn(groups(stage_mesh(n_stages, devices=CPUS)), STAGE, axis="stage")
    x = np.random.default_rng(1).normal(size=(n_micro, 2, CTX, WIDTH)).astype(np.float32)
    with torch.no_grad():
        got = run(_stacked(layers, n_stages), torch.from_numpy(x))
    want = np.asarray(jax.jit(jax.vmap(lambda xi: _jax_sequential(jax_params, xi)))(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_pipeline_gradients_match_sequential(groups):
    n_stages, n_layers, n_micro = 2, 4, 3
    layers, jax_params = _layers(n_layers, seed=3)
    run = make_pipeline_fn(groups(stage_mesh(n_stages, devices=CPUS)), STAGE, axis="stage")
    x = np.random.default_rng(2).normal(size=(n_micro, 2, CTX, WIDTH)).astype(np.float32)
    stacked = {k: v.requires_grad_(True) for k, v in _stacked(layers, n_stages).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (run(stacked, xt) ** 2).sum()
    loss.backward()
    want_loss, want_grads = _jax_loss_and_grads(jax_params, jnp.asarray(x))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _check_grads(stacked, layers, torch.from_numpy(x), want_grads, n_stages)
    want_gx = jax.jit(jax.grad(lambda x: jnp.sum(jnp.stack(
        [_jax_sequential(jax_params, xi) for xi in x]) ** 2)))(jnp.asarray(x))
    gx = np.asarray(want_gx)
    assert np.abs(xt.grad.numpy() - gx).max() <= 1e-5 * np.abs(gx).max()


def test_pipeline_rejects_unknown_batch_axis(groups):
    with pytest.raises(ValueError, match="no 'data' axis"):
        make_pipeline_fn(groups(stage_mesh(2, devices=CPUS)), STAGE, batch_axis="data")


def test_pipeline_validates_stage_count(groups):
    layers, _ = _layers(2, seed=0)
    g = groups(stage_mesh(2, devices=CPUS))
    run = make_pipeline_fn(g, STAGE)
    bad = _stacked(layers[:1], 1)
    with pytest.raises(ValueError, match="leading dims"):
        run(bad, torch.zeros((2, 2, CTX, WIDTH)))
    with pytest.raises(ValueError, match="no 'pp' axis"):
        make_pipeline_fn(g, STAGE, axis="pp")


def test_pipeline_composes_with_data_parallelism(groups):
    """dp x pp on one (data = 2, stage = 2) grid of four ranks: forward and
    gradients match the sequential apply; the rows' parameter gradients
    are summed over the data axis."""
    n_stages, n_layers, n_micro, n_data, batch = 2, 4, 3, 2, 4
    layers, jax_params = _layers(n_layers, seed=5)
    mesh = stage_mesh(n_stages, devices=CPUS, n_data=n_data)
    assert mesh.shape == {"data": n_data, "stage": n_stages}
    run = make_pipeline_fn(groups(mesh), STAGE, axis="stage", batch_axis="data")
    x = np.random.default_rng(6).normal(size=(n_micro, batch, CTX, WIDTH)).astype(np.float32)
    stacked = {k: v.requires_grad_(True) for k, v in _stacked(layers, n_stages).items()}
    y = run(stacked, torch.from_numpy(x))
    want = np.asarray(jax.jit(jax.vmap(lambda xi: _jax_sequential(jax_params, xi)))(x))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=2e-5, atol=2e-5)
    loss = (y ** 2).sum()
    loss.backward()
    want_loss, want_grads = _jax_loss_and_grads(jax_params, jnp.asarray(x))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _check_grads(stacked, layers, torch.from_numpy(x), want_grads, n_stages)


def test_pipeline_validates_data_sharding_preconditions(groups):
    layers, _ = _layers(2, seed=7)
    run = make_pipeline_fn(groups(stage_mesh(2, devices=CPUS, n_data=2)), STAGE,
                           axis="stage", batch_axis="data")
    stacked = _stacked(layers, 2)
    with pytest.raises(ValueError, match="rank >= 2"):
        run(stacked, torch.zeros((4,)))
    with pytest.raises(ValueError, match="divide evenly"):
        run(stacked, torch.zeros((2, 3, CTX, WIDTH)))
