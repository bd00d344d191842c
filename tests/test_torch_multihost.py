"""The port's multi-host pieces against the JAX package's: `shard_for_host`
on the same lists, `merge_host_outputs` on the same files (byte-equal
outputs), `--host_shard` in the nuScenes lift, masks and e2e CLIs (the
stride [1::2] for host 1 of 2, e2e's `{out}.host1`, as
tests/test_e2e_waymo.py:169 holds JAX's), and the `--data_parallel`
validation with the words JAX's tests match (tests/test_filters.py:213-225).
"""

import json
import os

import pytest

from cm3d_tpu.parallel.multihost import shard_for_host as jax_shard_for_host
from cm3d_tpu.pipelines import e2e as jax_e2e
from cm3d_tpu_torch.parallel import multihost
from cm3d_tpu_torch.parallel.mesh import dp_mesh, shard_batch, validate_data_parallel
from cm3d_tpu_torch.pipelines import e2e, lift, masks

SCENES = [f"scene-{i:04d}" for i in range(11)]


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (0, 3), (2, 3), (5, 8),
                                         (7, 8), (3, 16)])
def test_shard_for_host_matches_jax(index, count):
    got = multihost.shard_for_host(SCENES, index, count)
    assert got == jax_shard_for_host(SCENES, index, count)
    # the hosts' shards partition the list
    parts = [multihost.shard_for_host(SCENES, i, count) for i in range(count)]
    assert sorted(sum(parts, [])) == sorted(SCENES)


def test_shard_for_host_defaults(monkeypatch, tmp_path):
    """From RANK / WORLD_SIZE when no group is initialised, else (0, 1);
    from torch.distributed's group once one is."""
    import torch.distributed as dist

    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert multihost.process_index_and_count() == (2, 3)
    assert multihost.shard_for_host(SCENES) == jax_shard_for_host(SCENES, 2, 3)
    assert multihost.shard_for_host(SCENES, process_index=0) == SCENES[0::3]
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert multihost.process_index_and_count() == (0, 1)
    assert multihost.shard_for_host(SCENES) == SCENES
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        assert multihost.process_index_and_count() == (0, 1)  # the group wins
    finally:
        dist.destroy_process_group()


# --- merge_host_outputs --------------------------------------------------------

def _write_hosts(tmp_path):
    subs = [{"meta": {"use_camera": True, "use_lidar": True},
             "results": {"t0": [{"x": 1.5}], "t1": [{"x": 2}]}},
            {"meta": {"use_camera": True, "use_lidar": True},
             "results": {"t2": [{"x": 3}], "t1": [{"x": 4}]}}]
    for i, sub in enumerate(subs):
        (tmp_path / f"sub.json.host{i}").write_text(json.dumps(sub))
    for i, blob in enumerate((b"\x0a\x03abc\x0a\x01d", b"\x0a\x02ef")):
        (tmp_path / f"pred.bin.host{i}").write_bytes(blob)
    # KITTI: one host in the flat two-stage layout, one in run_e2e_kitti's
    # pred/ + pseudo/ layout
    (tmp_path / "k0").mkdir()
    (tmp_path / "k0" / "000000.txt").write_text("Car 0 0 0\n")
    for kind in ("pred", "pseudo"):
        (tmp_path / "k1" / kind).mkdir(parents=True)
        (tmp_path / "k1" / kind / "000001.txt").write_text(f"Pedestrian {kind}\n")


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_merge_host_outputs_matches_jax(tmp_path):
    _write_hosts(tmp_path)
    hosts = lambda stem: [str(tmp_path / f"{stem}.host{i}") for i in range(2)]  # noqa: E731
    for pkg, tag in ((e2e, "port"), (jax_e2e, "jax")):
        pkg.merge_host_outputs(hosts("sub.json"), str(tmp_path / f"{tag}.json"), "nuscenes")
        pkg.merge_host_outputs(hosts("pred.bin"), str(tmp_path / f"{tag}.bin"), "waymo")
        pkg.merge_host_outputs([str(tmp_path / "k0"), str(tmp_path / "k1")],
                               str(tmp_path / f"{tag}_kitti"), "kitti")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    merged = json.loads((tmp_path / "port.json").read_text())
    assert merged["results"]["t1"] == [{"x": 2}, {"x": 4}]
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes() \
        == b"\x0a\x03abc\x0a\x01d\x0a\x02ef"
    got, want = _tree_bytes(tmp_path / "port_kitti"), _tree_bytes(tmp_path / "jax_kitti")
    assert got == want and sorted(got) == ["000000.txt", "pred/000001.txt",
                                           "pseudo/000001.txt"]
    with pytest.raises(ValueError, match="unknown dataset"):
        e2e.merge_host_outputs(hosts("sub.json"), str(tmp_path / "x"), "argoverse")


def test_merge_host_outputs_refuses_a_frame_of_two_hosts(tmp_path):
    for host in ("a", "b"):
        (tmp_path / host / "pred").mkdir(parents=True)
        (tmp_path / host / "pred" / "000007.txt").write_text(host)
    with pytest.raises(FileExistsError, match="two host shards"):
        e2e.merge_host_outputs([str(tmp_path / "a"), str(tmp_path / "b")],
                               str(tmp_path / "merged"), "kitti")
    with pytest.raises(FileExistsError):
        jax_e2e.merge_host_outputs([str(tmp_path / "a"), str(tmp_path / "b")],
                                   str(tmp_path / "merged_jax"), "kitti")


# --- --host_shard in the CLIs ------------------------------------------------------

@pytest.fixture
def host_1_of_2(monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")


def test_lift_cli_host_shard(host_1_of_2, monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(lift, "run_lift", lambda root, version, mask_dir, scenes, out, **kw:
                        seen.update(scenes=scenes, out=out))
    lift.main(["--dataroot", str(tmp_path), "--mask_dir", str(tmp_path / "m"), "--scenes",
               ",".join(SCENES[:5]), "--out", str(tmp_path / "o.json"), "--host_shard"])
    assert seen == {"scenes": SCENES[1:5:2], "out": str(tmp_path / "o.json")}


def test_masks_cli_host_shard(host_1_of_2, monkeypatch, tmp_path):
    """The stride is taken over the provider's scene list (as JAX's
    cm3d_tpu/pipelines/masks.py:1115-1118); the artifact manifest's lock
    serialises the hosts' writes to a shared --out_dir."""
    seen = {}
    monkeypatch.setattr(masks, "_nuscenes_provider",
                        lambda args: (None, list(SCENES[:4]), len))
    monkeypatch.setattr(masks, "build_models", lambda p, args, vocab, device, mesh=None: "models")
    monkeypatch.setattr(masks, "run_mask_stage",
                        lambda models, provider, scenes, frames_fn, out_dir, cfg, resume:
                        seen.update(scenes=scenes, out_dir=out_dir))
    masks.main(["--dataroot", str(tmp_path), "--out_dir", str(tmp_path / "a"),
                "--fake_weights", "--device", "cpu", "--host_shard"])
    assert seen == {"scenes": [SCENES[1], SCENES[3]], "out_dir": str(tmp_path / "a")}


@pytest.mark.parametrize("dataset,runner", [("nuscenes", "run_e2e"), ("waymo", "run_e2e_waymo"),
                                            ("kitti", "run_e2e_kitti")])
def test_e2e_cli_host_shard_writes_its_host_file(host_1_of_2, monkeypatch, tmp_path, dataset,
                                                 runner):
    seen = {}

    def fake_run(*args, **kw):
        seen["scenes"], seen["out"] = args[-3], args[-2]

    monkeypatch.setattr(e2e, runner, fake_run)
    monkeypatch.setattr(e2e, "build_models", lambda p, args, vocab, device, mesh=None: "models")
    e2e.main(["--dataset", dataset, "--dataroot", str(tmp_path), "--scenes", "0,1,2,3,4",
              "--out", str(tmp_path / "o"), "--fake_weights", "--device", "cpu",
              "--host_shard"])
    want = [1, 3] if dataset == "kitti" else ["1", "3"]
    assert seen == {"scenes": want, "out": str(tmp_path / "o") + ".host1"}
    # one host: the stride is everything and the output keeps its name
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    e2e.main(["--dataset", dataset, "--dataroot", str(tmp_path), "--scenes", "0,1",
              "--out", str(tmp_path / "o"), "--fake_weights", "--device", "cpu",
              "--host_shard"])
    assert seen["out"] == str(tmp_path / "o")


# --- the --data_parallel validation --------------------------------------------------

def test_data_parallel_validation_uses_jaxs_words(tmp_path):
    """JAX's dp_mesh checks, in its words: positive, dividing the batch,
    within the available devices (cores for gloo ranks on the CPU); and a
    process that already holds a default group cannot start another."""
    import torch.distributed as dist

    with pytest.raises(SystemExit, match="positive"):
        validate_data_parallel(-2, 2, "cpu")
    with pytest.raises(SystemExit, match="must be positive"):
        dp_mesh(0, 2, "cpu", None)
    with pytest.raises(SystemExit, match="divide"):
        validate_data_parallel(3, 2, "cpu")
    n = (os.cpu_count() or 1) * 2
    with pytest.raises(SystemExit, match=f"exceeds {os.cpu_count()} available devices"):
        validate_data_parallel(n, n, "cpu")
    validate_data_parallel(2, 4, "cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(SystemExit, match="already holds one"):
            validate_data_parallel(2, 4, "cpu")
    finally:
        dist.destroy_process_group()


def test_shard_batch_takes_each_ranks_rows():
    """shard_batch: rank r's rows r*B/N ... (r+1)*B/N - 1 of every tensor of
    a nested batch-major tree; other leaves ride along; a batch that does
    not split, or leaves of two batch sizes, raise."""
    import numpy as np
    import torch

    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from test_torch_lift import SMALL, SYN

    from cm3d_tpu_torch.config import LiftStageConfig

    rng = np.random.default_rng(0)
    cfg = LiftStageConfig(**SMALL)
    frames = to_device(stack_keyframes([make_keyframe(SyntheticConfig(**SYN), cfg, rng)
                                        for _ in range(4)]).frames, "cpu")
    for rank in range(2):
        part = shard_batch(frames, rank, 2)
        assert type(part) is type(frames) and type(part.cameras) is type(frames.cameras)
        assert torch.equal(part.points, frames.points[2 * rank:2 * rank + 2])
        assert torch.equal(part.cameras.intrinsics,
                           frames.cameras.intrinsics[2 * rank:2 * rank + 2])
    tree = {"a": torch.arange(6).reshape(3, 2), "b": (None, 7)}
    assert shard_batch(tree, 2, 3)["b"] == (None, 7)
    assert torch.equal(shard_batch(tree, 2, 3)["a"], torch.tensor([[4, 5]]))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(tree, 0, 2)
    with pytest.raises(ValueError, match="same leading"):
        shard_batch((torch.zeros(2), torch.zeros(4)), 0, 2)
