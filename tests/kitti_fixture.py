"""A seeded KITTI root for the port's tests: calib / velodyne / image_2
under `training/` and the mask artifacts of its planted objects. Needs only
numpy, scipy, PIL and the port (no JAX), so the card tests can use it too.
"""

import numpy as np

from cm3d_tpu_torch.config import SHAPE_PRIORS_CHATGPT
from cm3d_tpu_torch.datasets.artifacts import FrameMasks, MaskArtifactStore
from cm3d_tpu_torch.datasets.kitti.calib import Calibration

IMAGE_RATIO = 0.8366  # KITTI_LIFT.image_ratio
CANVAS_WH = (1024, 320)  # the KITTI frontend's default mask canvas
IMAGE_WH = ((1242, 375), (1224, 370), (1238, 374))  # native KITTI sizes, by frame
NAMES = ("car", "pedestrian", "car", "truck", "bicycle", "car")


def _make_calib_txt() -> str:
    """KITTI-like calib with exact rotations (tests/test_kitti.py's)."""
    from scipy.spatial.transform import Rotation as R

    r0 = R.from_euler("xyz", [0.004, -0.0085, 0.0101]).as_matrix()
    # velodyne (x fwd, y left, z up) -> camera (x right, y down, z fwd)
    base = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    v2c_r = R.from_euler("xyz", [0.002, -0.001, 0.007]).as_matrix() @ base
    v2c_t = np.array([-0.0246, -0.0613, -0.3321])
    p2 = np.array([[707.0493, 0, 604.0814, 45.75831],
                   [0, 707.0493, 180.5066, -0.3454157],
                   [0, 0, 1, 0.004981016]])

    def fmt(m):
        return " ".join(repr(float(v)) for v in np.asarray(m).ravel())

    v2c = np.concatenate([v2c_r, v2c_t[:, None]], axis=1)
    return (f"P0: {fmt(p2)}\nP1: {fmt(p2)}\nP2: {fmt(p2)}\nP3: {fmt(p2)}\n"
            f"R0_rect: {fmt(r0)}\nTr_velo_to_cam: {fmt(v2c)}\n"
            f"Tr_imu_to_velo: {fmt(np.eye(3, 4))}\n")


CALIB_TXT = _make_calib_txt()


def make_kitti_root(root, mask_dir, n_frames=3, seed=0, image_wh=IMAGE_WH):
    """A KITTI root at `root` and the mask artifacts of its planted objects
    in `mask_dir` (scene "kitti", one per frame index): a ground patch and 6
    point clusters a frame, each cluster's projection an ellipse on the
    1024 x 320 canvas; image_2 PNGs of the sizes `image_wh` gives in turn
    (KITTI's native ones unless given; none when empty)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("calib", "velodyne", "image_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    store = MaskArtifactStore(mask_dir)
    mw, mh = CANVAS_WH
    xs, ys = np.arange(mw)[:, None], np.arange(mh)[None, :]
    for idx in range(n_frames):
        calib_path = root / "training" / "calib" / f"{idx:06d}.txt"
        calib_path.write_text(CALIB_TXT)
        a, b, k = Calibration(calib_path).rect_chain()
        ksc = k * IMAGE_RATIO
        ksc[2, 2] = 1.0
        pts = [rng.uniform([-40, -40, -1.8], [40, 40, -1.5], (3000, 3))]
        ms, labels, scores = [], [], []
        for name in NAMES:
            w, l, h = SHAPE_PRIORS_CHATGPT[name]
            center = np.array([rng.uniform(8, 30), rng.uniform(-7, 7), 0.0])
            pts.append(center + rng.normal(0, 1, (150, 3)) * np.array([l, w, h]) / 4)
            cam = a @ center + b
            uvw = ksc @ cam
            px, py = uvw[0] / uvw[2], uvw[1] / uvw[2]
            if not (5 < px < mw - 5 and 5 < py < mh - 5):
                continue
            rx = max(8, int(700 * IMAGE_RATIO * max(l, w) / (2 * cam[2])))
            ry = max(8, int(700 * IMAGE_RATIO * h / (2 * cam[2])))
            ms.append((((xs - px) / rx) ** 2 + ((ys - py) / ry) ** 2 <= 1).astype(np.uint8))
            labels.append(name)
            scores.append(float(rng.uniform(0.5, 1.0)))
        raw = np.zeros((sum(len(p) for p in pts), 4), np.float32)
        raw[:, :3] = np.concatenate(pts)
        raw[:, 3] = rng.random(len(raw))
        raw.tofile(root / "training" / "velodyne" / f"{idx:06d}.bin")
        store.write_frame("kitti", idx, FrameMasks(labels, scores, [0] * len(labels),
                                                   np.stack(ms)))
        if image_wh:
            w, h = image_wh[idx % len(image_wh)]
            Image.fromarray((rng.random((h, w, 3)) * 80 + 60).astype(np.uint8)).save(
                root / "training" / "image_2" / f"{idx:06d}.png")
    return root
