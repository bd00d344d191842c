"""The port's conformance runbook (cm3d_tpu_torch/conform.py): the eight
tests of tests/test_conform.py on the port's verify -> convert -> e2e ->
eval orchestration, at fixture scale with the pipeline phases stubbed, plus
--camera_mesh reaching the model builders, --quant_int8, ZoeDepth
and GroundingDINO running, the Detic / CLIP conversions, and main's exit
codes. (conform's gdino family on a GroundingDINO file:
tests/test_torch_gdino_cli.py.)

Checkpoints are the JAX package's fixture-scale fakes (tests/test_sam.py,
tests/test_torch_checkpoints.py), saved as released torch files."""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_sam import _fake_torch_sd
from test_torch_checkpoints import _fake_detic_sd, _save_detectron2
from test_torch_clip_text import fake_clip_sd

from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu_torch import conform
from cm3d_tpu_torch.models.checkpoints import load_params
from cm3d_tpu_torch.models.clip_text import CLIP_TEXT_TEST
from cm3d_tpu_torch.models.detic import DETIC_TEST
from cm3d_tpu_torch.models.sam import SAM_TEST


def _args(**kw):
    d = dict(sam="", sam_size="vit_h", detic="", clip="", bpe="", zoe="",
             gdino="", gdino_vocab="", probe=False, quant_int8=False,
             dataset="nuscenes", dataroot="", version="v1.0-mini",
             scenes="", out="", fake_weights=False, skip_pipeline=False,
             skip_eval=False, device="cpu")
    d.update(kw)
    return argparse.Namespace(**d)


def _save_sam_ckpt(tmp_path, corrupt=False):
    sd = _fake_torch_sd(JAX_SAM_TEST)
    if corrupt:
        del sd["image_encoder.pos_embed"]
    path = tmp_path / "sam_test.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


def test_verify_and_convert_fixture_scale(tmp_path):
    """Real phases 1+2 at SAM_TEST scale: verify report written, the
    converted state dict saved and loadable (equal to the file's tensors),
    exit code 0."""
    ckpt = _save_sam_ckpt(tmp_path)
    out = tmp_path / "conform"
    report, rc = conform.run_conform(
        _args(sam=ckpt, out=str(out)), cfg_overrides={"sam": SAM_TEST},
    )
    assert rc == 0 and report["ok"]
    entry = report["models"]["sam"]
    assert entry["ok"] and entry["kind"] == "torch"
    assert entry["verify"]["missing"] == 0
    assert entry["verify"]["mismatched"] == 0
    assert Path(entry["verify"]["report"]).is_file()
    params = load_params(entry["converted"])
    want = torch.load(ckpt, weights_only=True)
    assert set(params) == set(want)
    for k in want:
        torch.testing.assert_close(params[k], want[k], rtol=0, atol=0)
    # no dataroot: pipeline+eval skipped, report file on disk
    assert report["e2e"]["skipped"] and report["eval"]["skipped"]
    assert json.loads((out / "conform_report.json").read_text())["ok"]


def test_detic_and_clip_convert_to_the_ports_keys(tmp_path):
    """A detectron2 Detic file and a CLIP file at fixture scale: verified
    clean, converted (fc1 permuted, CLIP's keys), and the saved directories
    load strictly into the port's modules."""
    from cm3d_tpu_torch.models.clip_text import ClipTextEncoder
    from cm3d_tpu_torch.models.convert import load_released_state_dict
    from cm3d_tpu_torch.models.detic import Detic

    _save_detectron2(_fake_detic_sd(DETIC_TEST), tmp_path / "detic.pth")
    clip_sd = {k: torch.from_numpy(np.array(v)) for k, v in fake_clip_sd(CLIP_TEXT_TEST).items()}
    torch.save(clip_sd, tmp_path / "clip.pth")
    report, rc = conform.run_conform(
        _args(detic=str(tmp_path / "detic.pth"), clip=str(tmp_path / "clip.pth"),
              out=str(tmp_path / "c")),
        cfg_overrides={"detic": DETIC_TEST, "clip": CLIP_TEXT_TEST})
    assert rc == 0, report
    for name, module in (("detic", Detic(DETIC_TEST)), ("clip", ClipTextEncoder(CLIP_TEXT_TEST))):
        entry = report["models"][name]
        assert entry["ok"] and entry["verify"]["missing"] == 0
        load_released_state_dict(module, load_params(entry["converted"]), verbose=False)


def test_broken_checkpoint_reported_not_fatal(tmp_path):
    """A checkpoint missing a key the module demands: entry not ok, rc 1,
    but the report still writes (other models could still run)."""
    ckpt = _save_sam_ckpt(tmp_path, corrupt=True)
    out = tmp_path / "conform"
    report, rc = conform.run_conform(
        _args(sam=ckpt, out=str(out)), cfg_overrides={"sam": SAM_TEST},
    )
    assert rc == 1 and not report["ok"]
    entry = report["models"]["sam"]
    assert not entry["ok"]
    assert (out / "conform_report.json").is_file()


def test_converted_dir_skips_verify(tmp_path):
    """An already-converted directory passes straight through to e2e."""
    d = tmp_path / "converted_sam"
    d.mkdir()
    report, rc = conform.run_conform(
        _args(sam=str(d), out=str(tmp_path / "c")),
    )
    assert rc == 0
    entry = report["models"]["sam"]
    assert entry["kind"] == "converted" and entry["converted"] == str(d)
    assert entry["verify"] == "skipped"


def test_pipeline_phase_threading(tmp_path, monkeypatch):
    """Phases 3+4 with stubbed CLIs: the e2e argv carries the CONVERTED
    checkpoint dirs and the device, the eval metrics land in the report
    next to the reference headline."""
    ckpt = _save_sam_ckpt(tmp_path)
    out = tmp_path / "conform"
    seen = {}

    def fake_e2e(argv):
        seen["e2e"] = argv
        i = argv.index("--out") + 1
        Path(argv[i]).write_text(json.dumps(
            {"results": {"tok1": [{}, {}], "tok2": [{}]}}
        ))

    def fake_eval(argv):
        seen["eval"] = argv
        return {"mean_ap": 0.231, "nd_score": 0.222}

    monkeypatch.setattr(conform, "_e2e_main", fake_e2e)
    monkeypatch.setattr(conform, "_eval_main", fake_eval)

    report, rc = conform.run_conform(
        _args(sam=ckpt, out=str(out), dataroot="/data/nusc", scenes="scene-0061"),
        cfg_overrides={"sam": SAM_TEST},
    )
    assert rc == 0
    argv = seen["e2e"]
    i = argv.index("--sam_ckpt") + 1
    assert argv[i] == report["models"]["sam"]["converted"]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert report["e2e"]["n_samples"] == 2
    assert report["e2e"]["n_boxes"] == 3
    assert seen["eval"][0] == report["e2e"]["out"]
    assert report["eval"]["mAP"] == 0.231
    assert report["eval"]["NDS"] == 0.222
    assert report["eval"]["reference_headline"]["mAP"] == 23.0


def test_fake_weights_dry_run(tmp_path, monkeypatch):
    """--fake_weights: the runbook dry-runs without any checkpoints —
    the e2e argv asks for fake models, eval still runs."""
    seen = {}

    def fake_e2e(argv):
        seen["e2e"] = argv
        Path(argv[argv.index("--out") + 1]).write_text(
            json.dumps({"results": {}})
        )

    monkeypatch.setattr(conform, "_e2e_main", fake_e2e)
    monkeypatch.setattr(conform, "_eval_main",
                        lambda argv: {"mean_ap": 0.0, "nd_score": 0.0})
    report, rc = conform.run_conform(
        _args(out=str(tmp_path / "c"), dataroot="/x", scenes="s",
              fake_weights=True),
    )
    assert rc == 0
    assert "--fake_weights" in seen["e2e"]
    assert "--sam_ckpt" not in seen["e2e"]


def test_eval_skipped_after_e2e_failure(tmp_path, monkeypatch):
    def boom(argv):
        raise RuntimeError("no such scene")

    monkeypatch.setattr(conform, "_e2e_main", boom)
    called = []
    monkeypatch.setattr(conform, "_eval_main",
                        lambda argv: called.append(argv))
    report, rc = conform.run_conform(
        _args(out=str(tmp_path / "c"), dataroot="/x", scenes="s",
              fake_weights=True),
    )
    assert rc == 1
    assert "no such scene" in report["e2e"]["error"]
    assert report["eval"]["skipped"] and not called


def test_non_nuscenes_dataset_skips_json_summary_and_eval(tmp_path,
                                                          monkeypatch):
    """--dataset waymo: the e2e artifact is a .bin proto, not submission
    JSON — the report records its size instead of mis-parsing it, the
    nuScenes eval phase is skipped with a reason, and rc stays 0."""
    seen = {}

    def fake_e2e(argv):
        seen["e2e"] = argv
        Path(argv[argv.index("--out") + 1]).write_bytes(b"\x0a\x04bin!")

    called = []
    monkeypatch.setattr(conform, "_e2e_main", fake_e2e)
    monkeypatch.setattr(conform, "_eval_main",
                        lambda argv: called.append(argv))
    report, rc = conform.run_conform(
        _args(out=str(tmp_path / "c"), dataset="waymo", dataroot="/x",
              scenes="s", fake_weights=True),
    )
    assert rc == 0
    assert "--dataset" in seen["e2e"] and "waymo" in seen["e2e"]
    assert report["e2e"]["artifact_bytes"] == 6
    assert "n_samples" not in report["e2e"]
    assert report["eval"]["skipped"] and "waymo" in report["eval"]["reason"]
    assert not called


def test_non_nuscenes_missing_artifact_is_error(tmp_path, monkeypatch):
    """A non-nuScenes e2e phase that writes NOTHING must fail the gate."""
    monkeypatch.setattr(conform, "_e2e_main", lambda argv: None)
    monkeypatch.setattr(conform, "_eval_main", lambda argv: None)
    report, rc = conform.run_conform(
        _args(out=str(tmp_path / "c"), dataset="waymo", dataroot="/x",
              scenes="s", fake_weights=True),
    )
    assert rc == 1
    assert "no artifact" in report["e2e"]["error"]


def test_unported_phases_name_their_roadmap_items(tmp_path, monkeypatch):
    """--quant_int8, ZoeDepth and GroundingDINO are ported (A12, A13b,
    A13c): --quant_int8 runs (the e2e argv carries it), and a missing
    ZoeDepth or GroundingDINO file fails its own phase, naming the file and
    no ROADMAP item (rc 1, the report still written). The e2e argv asks for
    gdino with its vocabulary, which the port's e2e CLI accepts (the run
    goes on to read the dataroot); --camera_mesh (A14e) reaches the model
    builders as a started two-rank (data,) mesh group."""
    seen = {}
    monkeypatch.setattr(conform, "_e2e_main", lambda argv: seen.setdefault("e2e", argv))
    report, rc = conform.run_conform(
        _args(zoe="zoe.pt", gdino="gdino.pth", gdino_vocab="vocab.txt",
              out=str(tmp_path / "c"), dataroot="/x", scenes="s", fake_weights=True,
              skip_eval=True, quant_int8=True))
    assert rc == 1 and (tmp_path / "c" / "conform_report.json").is_file()
    for name, path in (("gdino", "gdino.pth"), ("zoe", "zoe.pt")):
        assert path in report["models"][name]["error"]
        assert "A13" not in report["models"][name]["error"]
    argv = seen["e2e"]
    assert argv[argv.index("--detector") + 1] == "gdino" and "--quant_int8" in argv
    assert argv[argv.index("--gdino_vocab") + 1] == "vocab.txt"
    from cm3d_tpu_torch.pipelines import e2e
    from cm3d_tpu_torch.pipelines.e2e import main as e2e_main

    with pytest.raises(FileNotFoundError):
        e2e_main(argv)
    real_build = e2e.build_models

    def spy(p, args, vocabulary, device, mesh=None):
        seen["mesh"] = None if mesh is None else dict(mesh.mesh.shape)
        return real_build(p, args, vocabulary, device, mesh)

    monkeypatch.setattr(e2e, "build_models", spy)
    with pytest.raises(FileNotFoundError):
        e2e_main(argv + ["--camera_mesh", "2"])
    assert seen["mesh"] == {"data": 2, "model": 1}


def test_main_exit_codes_and_summary(tmp_path, capsys):
    """main: 1 for a file that is no checkpoint, 0 for a converted
    directory (its summary line printed), argparse's exit 2 for --dataroot
    without --scenes."""
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a checkpoint")
    assert conform.main(["--sam", str(bad), "--out", str(tmp_path / "a"),
                         "--device", "cpu"]) == 1
    assert "[sam] PROBLEMS (ValueError" in capsys.readouterr().out
    d = tmp_path / "already"
    d.mkdir()
    assert conform.main(["--sam", str(d), "--out", str(tmp_path / "b"),
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[sam] ok -> {d}" in out and "conform_report.json" in out
    with pytest.raises(SystemExit) as e:
        conform.main(["--dataroot", "/x", "--out", str(tmp_path / "c")])
    assert e.value.code == 2


def test_port_nuscenes_fixture_writes_the_jax_fixtures_dataroot(tmp_path):
    """tests/torch_nusc_fixture.py (the JAX-free dataroot `chip_smoke.py`
    runs conform on) writes what tests/nusc_fixture.py writes: the same
    files, the same LiDAR sweeps, images and mask artifacts byte for byte,
    the same table sizes and planted objects. Only the random tokens
    differ."""
    import pickle

    import nusc_fixture as jax_fixture
    import torch_nusc_fixture as port_fixture

    assert port_fixture.VERSION == jax_fixture.VERSION
    got = {}
    for name, fixture in (("jax", jax_fixture), ("port", port_fixture)):
        gt = fixture.make_fake_nuscenes(tmp_path / name, tmp_path / f"{name}_masks",
                                        n_frames=2, n_objects=6)
        got[name] = (gt, tmp_path / name, tmp_path / f"{name}_masks")

    def files(root):
        return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())

    (jgt, jroot, jmasks), (pgt, proot, pmasks) = got["jax"], got["port"]
    assert files(jroot) == files(proot) and files(jmasks) == files(pmasks)
    assert [o["name"] for o in jgt["objects"]] == [o["name"] for o in pgt["objects"]]
    for a, b in zip(jgt["objects"], pgt["objects"]):
        np.testing.assert_array_equal(a["center"], b["center"])
        assert (a["size"], a["cam"]) == (b["size"], b["cam"])
    for rel in files(jroot):
        if rel.suffix in (".bin", ".jpg"):
            assert (jroot / rel).read_bytes() == (proot / rel).read_bytes(), rel
        elif rel.suffix == ".json":
            assert len(json.loads((jroot / rel).read_text())) == \
                len(json.loads((proot / rel).read_text())), rel
    for rel in files(jmasks):
        if rel.suffix == ".pkl":  # run-length encoded masks
            assert pickle.loads((jmasks / rel).read_bytes()) == \
                pickle.loads((pmasks / rel).read_bytes()), rel
        elif rel.name.endswith("_data.json"):  # labels, scores, cameras
            assert json.loads((jmasks / rel).read_text()) == \
                json.loads((pmasks / rel).read_text()), rel
