"""The port's KITTI viz modules (cm3d_tpu_torch/datasets/kitti/viz.py and
viz3d.py): the JAX package's three tests (tests/test_kitti_viz.py) run on
the port's modules, and both packages' CLIs (`viz.main`, both passes, and
`viz3d.main`) on one fabricated KITTI root: every PNG's pixels, every depth
point cloud and every viewer HTML equal to JAX's, byte for byte. Host
numpy and PIL only; nothing here has a tolerance.
"""

import sys

import numpy as np
import pytest
from PIL import Image

import test_kitti_viz
from test_kitti import CALIB_TXT

from cm3d_tpu.datasets.kitti import viz as jax_viz
from cm3d_tpu.datasets.kitti import viz3d as jax_viz3d

from cm3d_tpu_torch.datasets import kitti as port_kitti
from cm3d_tpu_torch.datasets.kitti import viz, viz3d

# the JAX test bodies, each run with the port's modules in place of JAX's
_PORT_NAMES = {
    "lidar_to_top": viz.lidar_to_top, "top_to_image": viz.top_to_image,
    "draw_boxes_on_bev": viz.draw_boxes_on_bev,
}


@pytest.mark.parametrize("name", ["test_lidar_to_top_cell_values",
                                  "test_top_to_image_and_bev_drawing",
                                  "test_viewer3d_html_roundtrip"])
def test_jax_kitti_viz_tests_on_the_port(name, tmp_path, monkeypatch):
    for attr, fn in _PORT_NAMES.items():
        monkeypatch.setattr(test_kitti_viz, attr, fn)
    # the bodies import Calibration / Object3d and viz3d inside: serve the port's
    import cm3d_tpu.datasets.kitti as jax_kitti

    monkeypatch.setattr(jax_kitti, "Calibration", port_kitti.Calibration)
    monkeypatch.setattr(jax_kitti, "Object3d", port_kitti.Object3d)
    monkeypatch.setitem(sys.modules, "cm3d_tpu.datasets.kitti.viz3d", viz3d)
    fn = getattr(test_kitti_viz, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


@pytest.fixture()
def kitti_root(tmp_path):
    """Two frames: velodyne sweeps, calib, labels (one box leaves the BEV
    crop), a 120 x 380 image for frame 0 only, a depth png for frame 1
    only."""
    rng = np.random.default_rng(0)
    split = tmp_path / "kitti" / "training"
    for sub in ("calib", "velodyne", "label_2", "image_2", "depth"):
        (split / sub).mkdir(parents=True)
    for idx in (0, 1):
        (split / "calib" / f"{idx:06d}.txt").write_text(CALIB_TXT)
        pts = np.concatenate([rng.uniform([1, -25, -1.8], [65, 25, 0.3], (4000, 3)),
                              rng.random((4000, 1))], axis=1).astype(np.float32)
        pts.tofile(split / "velodyne" / f"{idx:06d}.bin")
        (split / "label_2" / f"{idx:06d}.txt").write_text(
            "Car 0.00 0 -1.57 100.0 120.0 200.0 200.0 1.50 1.80 4.20 2.00 1.60 15.00 0.10\n"
            "Pedestrian 0.00 0 0.30 300.0 100.0 330.0 180.0 1.80 0.60 0.70 -4.00 1.60 9.00 0.40\n"
            "Car 0.00 0 0.00 0.0 0.0 10.0 10.0 1.50 1.80 4.20 40.00 1.60 20.00 0.00\n")
    Image.fromarray(rng.integers(0, 255, (120, 380, 3)).astype(np.uint8)).save(
        split / "image_2" / "000000.png")
    depth = (rng.uniform(2, 40, (120, 380)) * 256).astype(np.uint16)
    Image.fromarray(depth).save(split / "depth" / "000001.png")
    preds = tmp_path / "pred"
    preds.mkdir()
    (preds / "000000.txt").write_text(
        "Cyclist 0.00 0 0.00 50.0 50.0 90.0 150.0 1.70 0.60 1.80 3.00 1.60 12.00 1.00 0.9\n")
    return tmp_path / "kitti", preds


def _same_files(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    for name in names:
        if name.endswith(".png"):
            pa, pb = np.asarray(Image.open(a / name)), np.asarray(Image.open(b / name))
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            np.testing.assert_array_equal(pa, pb, err_msg=name)
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


def test_viz_clis_write_what_jax_writes(kitti_root, tmp_path):
    root, preds = kitti_root
    for pkg, out in ((jax_viz, "jax"), (viz, "port")):
        pkg.main(["--dataroot", str(root), "--indices", "0,1", "--out", str(tmp_path / out),
                  "--pred_dir", str(preds)])
        pkg.main(["--dataroot", str(root), "--indices", "0,1", "--out",
                  str(tmp_path / f"{out}_depth"), "--gen_depth"])
    for pkg, out in ((jax_viz3d, "jax3d"), (viz3d, "port3d")):
        pkg.main(["--dataroot", str(root), "--indices", "0,1", "--out_dir",
                  str(tmp_path / out), "--pred_dir", str(preds)])
    assert _same_files(tmp_path / "port", tmp_path / "jax") == [
        "000000_bev.png", "000000_img.png", "000001_bev.png"]
    assert _same_files(tmp_path / "port_depth", tmp_path / "jax_depth") == ["000001.bin"]
    assert _same_files(tmp_path / "port3d", tmp_path / "jax3d") == [
        "000000.html", "000001.html"]
    bev = np.asarray(Image.open(tmp_path / "port" / "000000_bev.png"))
    assert (bev[..., 0].astype(int) - bev[..., 1].astype(int) > 50).any()  # boxes drawn
