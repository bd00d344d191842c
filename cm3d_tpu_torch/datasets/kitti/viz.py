"""KITTI visualization + BEV rasterization (PIL-based, no mayavi/cv2).
Mirrors `cm3d_tpu/datasets/kitti/viz.py` (numpy and PIL on the host).

Rebuild of the reference's visualization suite (src/kitti/kitti_object.py:
show_image_with_boxes:185, show_lidar_topview_with_boxes, dataset_viz:736)
and the `lidar_to_top` BEV rasterizer (src/kitti/kitti_utils.py:431-516).
The rasterizer keeps the reference's exact channel semantics (per-slice max
height, top intensity, log-count density, the (-x, -y) index flip); drawing
uses PIL instead of mayavi so it runs headless.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cm3d_tpu_torch.datasets.kitti.calib import Calibration, Object3d, compute_box_3d

# Reference BEV crop (kitti_utils.py:15-24 module constants, verbatim)
TOP_X_MIN, TOP_X_MAX, TOP_X_DIVISION = 0.0, 100.0, 0.2
TOP_Y_MIN, TOP_Y_MAX, TOP_Y_DIVISION = -30.0, 30.0, 0.2
TOP_Z_MIN, TOP_Z_MAX, TOP_Z_DIVISION = -3.5, 0.6, 0.3

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # bottom
    (4, 5), (5, 6), (6, 7), (7, 4),  # top
    (0, 4), (1, 5), (2, 6), (3, 7),  # pillars
]


def lidar_to_top(lidar: np.ndarray) -> np.ndarray:
    """[N, 4] velodyne points -> [H, W, Zn+2] BEV feature map
    (vectorized; same values as the reference's per-cell loops)."""
    m = (
        (lidar[:, 0] > TOP_X_MIN) & (lidar[:, 0] < TOP_X_MAX)
        & (lidar[:, 1] > TOP_Y_MIN) & (lidar[:, 1] < TOP_Y_MAX)
        & (lidar[:, 2] > TOP_Z_MIN) & (lidar[:, 2] < TOP_Z_MAX)
    )
    pts = lidar[m]
    qx = ((pts[:, 0] - TOP_X_MIN) // TOP_X_DIVISION).astype(np.int32)
    qy = ((pts[:, 1] - TOP_Y_MIN) // TOP_Y_DIVISION).astype(np.int32)
    qz = (pts[:, 2] - TOP_Z_MIN) / TOP_Z_DIVISION
    pr = pts[:, 3]

    xn = int((TOP_X_MAX - TOP_X_MIN) // TOP_X_DIVISION) + 1
    yn = int((TOP_Y_MAX - TOP_Y_MIN) // TOP_Y_DIVISION) + 1
    zn = int((TOP_Z_MAX - TOP_Z_MIN) / TOP_Z_DIVISION)
    top = np.zeros((xn, yn, zn + 2), np.float32)
    if len(pts) == 0:
        return top

    cell = qx.astype(np.int64) * yn + qy
    order = np.argsort(cell, kind="stable")
    cell_s, qz_s, pr_s = cell[order], qz[order], pr[order]
    uniq, starts, counts = np.unique(cell_s, return_index=True, return_counts=True)
    for u, s, c in zip(uniq, starts, counts):
        x, y = int(u // yn), int(u % yn)
        zz = qz_s[s : s + c]
        rr = pr_s[s : s + c]
        yy, xx = -x, -y  # reference index flip (kitti_utils.py:478,486)
        top[yy, xx, zn + 1] = min(1.0, np.log(c + 1) / math.log(32))
        top[yy, xx, zn] = rr[np.argmax(zz)]
        for z in range(zn):
            inz = (zz >= z) & (zz <= z + 1)
            if inz.any():
                top[yy, xx, z] = max(0.0, float(zz[inz].max()) - z)
    return top


def top_to_image(top: np.ndarray) -> np.ndarray:
    """BEV feature map -> grayscale uint8 image (density + max height)."""
    den = top[:, :, -1]
    hgt = top[:, :, :-2].max(axis=2)
    img = 0.5 * den + 0.5 * np.clip(hgt, 0, 1)
    return (img * 255).astype(np.uint8)


def draw_boxes_on_image(
    image: np.ndarray,
    objects: Sequence[Object3d],
    calib: Calibration,
    color: Tuple[int, int, int] = (0, 255, 60),
) -> np.ndarray:
    """Project 3D boxes and draw wireframes (reference show_image_with_boxes)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(image)
    draw = ImageDraw.Draw(im)
    for obj in objects:
        corners = compute_box_3d(obj)
        if (corners[:, 2] <= 0.1).any():
            continue
        uv = calib.project_rect_to_image(corners)
        for a, b in _BOX_EDGES:
            draw.line(
                [tuple(uv[a]), tuple(uv[b])], fill=color, width=2
            )
        draw.text(tuple(uv[4]), obj.type, fill=color)
    return np.asarray(im)


def draw_boxes_on_bev(
    top_image: np.ndarray,
    objects: Sequence[Object3d],
    calib: Calibration,
    color: Tuple[int, int, int] = (255, 80, 80),
) -> np.ndarray:
    """Draw box footprints on the BEV raster (reference
    show_lidar_topview_with_boxes intent)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(top_image).convert("RGB")
    draw = ImageDraw.Draw(im)
    w_img, h_img = top_image.shape[1], top_image.shape[0]
    for obj in objects:
        corners = compute_box_3d(obj)[:4]  # bottom face, rect frame
        velo = calib.project_rect_to_velo(corners)
        qx = ((velo[:, 0] - TOP_X_MIN) // TOP_X_DIVISION).astype(int)
        qy = ((velo[:, 1] - TOP_Y_MIN) // TOP_Y_DIVISION).astype(int)
        # the (-q) % size flip only mirrors IN-crop cells; a corner past
        # the crop would modulo-wrap to the opposite image edge, so skip
        # boxes that leave the raster instead of drawing them wrapped
        if ((qy < 0) | (qy >= w_img) | (qx < 0) | (qx >= h_img)).any():
            continue
        px = (-qy) % w_img
        py = (-qx) % h_img
        draw.polygon(list(zip(px.tolist(), py.tolist())), outline=color)
    return np.asarray(im)


def dataset_viz(root: str, indices: List[int], out_dir: str,
                pred_dir: Optional[str] = None) -> None:
    """Batch viz (reference dataset_viz + CLI, kitti_object.py:736,
    886-984): writes image-with-boxes and BEV pngs per frame."""
    import os

    from PIL import Image

    from cm3d_tpu_torch.datasets.kitti.frontend import KittiDataset

    os.makedirs(out_dir, exist_ok=True)
    ds = KittiDataset(root)
    for idx in indices:
        calib = ds.get_calibration(idx)
        objects = ds.get_label_objects(idx)
        if pred_dir:
            from cm3d_tpu_torch.datasets.kitti.calib import read_label

            p = f"{pred_dir}/{idx:06d}.txt"
            if os.path.exists(p):
                objects = list(objects) + read_label(p)
        lidar = ds.get_lidar(idx)
        top = lidar_to_top(lidar)
        bev = draw_boxes_on_bev(top_to_image(top), objects, calib)
        Image.fromarray(bev).save(f"{out_dir}/{idx:06d}_bev.png")
        img_path = ds.get_image_path(idx)
        if img_path.exists():
            img = np.asarray(Image.open(img_path).convert("RGB"))
            out = draw_boxes_on_image(img, objects, calib)
            Image.fromarray(out).save(f"{out_dir}/{idx:06d}_img.png")


def gen_depth_pc(root: str, indices: List[int], out_dir: str,
                 constraint_box: bool = True) -> List[str]:
    """Depth-image -> velodyne point cloud .bin files (the reference viz
    suite's --gen_depth pass, kitti_object.py:510-534 save_depth): every
    frame with a depth png unprojects through the calib chain, gets the
    reference's fixed 0.5 intensity column, and writes {idx:06d}.bin
    float32 [N, 4]. Returns written paths."""
    import os

    from cm3d_tpu_torch.datasets.kitti.frontend import KittiDataset

    os.makedirs(out_dir, exist_ok=True)
    ds = KittiDataset(root)
    written = []
    for idx in indices:
        depth = ds.get_depth(idx)
        if depth is None:
            continue
        calib = ds.get_calibration(idx)
        pts = calib.project_depth_to_velo(depth, constraint_box)
        pc = np.concatenate(
            [pts, np.full((len(pts), 1), 0.5)], axis=1
        ).astype(np.float32)
        path = f"{out_dir}/{idx:06d}.bin"
        pc.tofile(path)
        written.append(path)
    return written


def main(argv=None):
    """Batch KITTI viz CLI (reference kitti_object.py argparse surface:
    --vis/--gen_depth/--const_box; mayavi windows become written pngs)."""
    import argparse

    p = argparse.ArgumentParser(description="KITTI viz / depth point clouds")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--indices", required=True,
                   help="comma-separated frame indices")
    p.add_argument("--out", required=True)
    p.add_argument("--pred_dir", default="")
    p.add_argument("--gen_depth", action="store_true",
                   help="write depth-png -> velodyne .bin point clouds "
                   "instead of box pngs (reference --gen_depth)")
    p.add_argument("--const_box", type=int, default=1,
                   help="clip depth points to the reference cbox "
                   "(kitti_utils.py:26)")
    args = p.parse_args(argv)
    indices = [int(i) for i in args.indices.split(",")]
    if args.gen_depth:
        gen_depth_pc(args.dataroot, indices, args.out,
                     constraint_box=bool(args.const_box))
    else:
        dataset_viz(args.dataroot, indices, args.out,
                    pred_dir=args.pred_dir or None)


if __name__ == "__main__":
    main()
