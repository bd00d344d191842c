"""The cells' inputs, made from the seed: keyframes, camera images,
detections and mask planes.

Frozen copies, noting their origins:
- `make_keyframe`: cm3d_tpu_torch/datasets/synthetic.py `make_keyframe`
  (LiDAR clutter and object clusters around a ring of six pinhole cameras,
  a lane grid), with the object masks painted on the device and any number
  of objects a frame.
- `detections` and `blob_planes`: the content swap of
  cm3d_tpu_torch/benchmarks.py `_realistic_load` (the JAX package's mask
  stage protocol): random-weight Detic finds nothing meaningful, so the
  detector's output is replaced by boxes drawn from the seed and the
  decoded planes by 120 x 90 px blobs, while the real device work stays on
  the stream.

Each camera's detection count is drawn from the seed, uniform over the
traffic's `detections_per_camera`, as the protocol draws it. What that does
to the decode, the prompt bucket of a frame (set by its busiest camera
after the host NMS and caps), is held to the protocol's expected share over
the pool: `small_bucket_frames` of the pool's frames fit the smallest
bucket, the rest do not, at places drawn from the seed. So every seed
decodes the same mix of buckets, and seeds change the content.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.tables import CLASSES, VOCABULARY


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32)


def _rotz(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (Shepperd's method)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _project(p_global, ego_t, ego_yaw, cam_t, cam_rot, intr):
    p = _rotz(ego_yaw).T @ (p_global - ego_t) - cam_t
    p = cam_rot.T @ p
    if p[2] <= 0.1:
        return -1.0, -1.0
    uvw = intr @ p
    return uvw[0] / uvw[2], uvw[1] / uvw[2]


def pack_planes(masks: torch.Tensor, n_words: int) -> torch.Tensor:
    """[M, W, H] bool -> [W, H, n_words] int32 bit-planes: bit m % 32 of
    word m // 32 (the lift's layout, ops/bitmask.py)."""
    m, w, h = masks.shape
    full = torch.zeros((n_words * 32, w, h), dtype=torch.int64, device=masks.device)
    full[:m] = masks.to(torch.int64)
    shifts = torch.arange(32, device=masks.device, dtype=torch.int64)[None, :, None, None]
    words = (full.reshape(n_words, 32, w, h) << shifts).sum(1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return words.permute(1, 2, 0).contiguous()


def unpack_planes(words: torch.Tensor, n: int) -> torch.Tensor:
    """[W, H, Mw] int32 bit-planes -> [n, W, H] bool."""
    bits = torch.arange(n, device=words.device)
    return ((words[..., bits >> 5] >> (bits & 31)) & 1).permute(2, 0, 1).bool()


def make_keyframe(traffic: dict, lift: dict, rng: np.random.Generator, device) -> dict:
    """One keyframe's host arrays (the Keyframe fields, cameras flattened)
    at nuScenes scale; the masks of its objects painted when the traffic
    asks for them, else left empty for the mask stage to fill."""
    c = traffic["cameras"]
    img_h, img_w = traffic["image_hw"]
    focal = traffic["focal"]
    ego_t = rng.uniform(-500, 500, 3).astype(np.float32)
    ego_t[2] = 0.0
    ego_yaw = rng.uniform(-np.pi, np.pi)
    cam_t = np.tile(np.array([1.0, 0.0, 1.6], np.float32), (c, 1))
    axes = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    cam_rot = [_rotz(2 * np.pi * i / c) @ axes for i in range(c)]
    cam_q = np.stack([_quat_from_matrix(r) for r in cam_rot]).astype(np.float32)
    intr = np.zeros((c, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = focal
    intr[:, 0, 2], intr[:, 1, 2], intr[:, 2, 2] = img_w / 2, img_h / 2, 1.0

    n = lift["max_points"]
    n_real = min(traffic["points_per_frame"], n)
    pts = [rng.uniform([-60, -60, -1.8], [60, 60, 3.0], size=(n_real, 3)) + ego_t]
    m_pad = lift["max_masks"]
    mask_cam = np.zeros(m_pad, np.int32)
    mask_label = np.zeros(m_pad, np.int32)
    mask_score = np.zeros(m_pad, np.float32)
    mask_valid = np.zeros(m_pad, bool)
    ellipses = []
    for j in range(min(traffic["objects_per_frame"], m_pad)):
        cam = int(rng.integers(0, c))
        heading = 2 * np.pi * cam / c
        dist = rng.uniform(8, 45)
        lateral = rng.uniform(-0.3, 0.3) * dist
        local = np.array([dist * np.cos(heading) - lateral * np.sin(heading),
                          dist * np.sin(heading) + lateral * np.cos(heading),
                          rng.uniform(0.2, 1.0)])
        center = _rotz(ego_yaw) @ local + ego_t
        pts.append(center + rng.normal(0, 0.5, size=(int(rng.integers(30, 400)), 3)))
        px, py = _project(center, ego_t, ego_yaw, cam_t[cam], cam_rot[cam], intr[cam])
        if not (2 < px < img_w - 2 and 2 < py < img_h - 2):
            continue
        ellipses.append((j, px, py, int(np.clip(1500.0 / dist, 6, 120)),
                         int(np.clip(1000.0 / dist, 6, 90))))
        mask_cam[j] = cam
        mask_label[j] = int(rng.integers(0, len(CLASSES)))
        mask_score[j] = rng.uniform(0.1, 1.0)
        mask_valid[j] = True

    pts = np.concatenate(pts)[:n]
    points = np.zeros((n, 4), np.float32)
    points[:len(pts), :3] = pts
    points[:len(pts), 3] = rng.random(len(pts))
    point_valid = np.zeros(n, bool)
    point_valid[:len(pts)] = True
    l_pad = lift["max_lane_points"]
    n_lane = min(4096, l_pad)
    lane_points = np.zeros((l_pad, 3), np.float32)
    lane_points[:n_lane, :2] = rng.uniform(-80, 80, size=(n_lane, 2)) + ego_t[:2]
    lane_points[:n_lane, 2] = rng.uniform(-np.pi, np.pi, size=n_lane)
    lane_valid = np.zeros(l_pad, bool)
    lane_valid[:n_lane] = True

    n_words = -(-m_pad // 32)
    if traffic["paint_masks"]:
        masks = torch.zeros((m_pad, img_w, img_h), dtype=torch.bool, device=device)
        if ellipses:
            e = torch.tensor(ellipses, dtype=torch.float64, device=device)
            xs = torch.arange(img_w, device=device, dtype=torch.float64)[None, :, None]
            ys = torch.arange(img_h, device=device, dtype=torch.float64)[None, None, :]
            inside = ((xs - e[:, 1, None, None]) / e[:, 3, None, None]) ** 2 \
                + ((ys - e[:, 2, None, None]) / e[:, 4, None, None]) ** 2 <= 1.0
            masks[e[:, 0].long()] = inside
        mask_bits = pack_planes(masks, n_words).cpu().numpy().view(np.uint32)
    else:
        mask_bits = np.zeros((img_w, img_h, n_words), np.uint32)
    return {
        "points": points, "point_valid": point_valid,
        "cam_ego_t": np.tile(ego_t, (c, 1)), "cam_ego_q": np.tile(_yaw_quat(ego_yaw), (c, 1)),
        "cam_t": cam_t, "cam_q": cam_q, "intrinsics": intr,
        "mask_bits": mask_bits, "mask_cam": mask_cam, "mask_label": mask_label,
        "mask_score": mask_score, "mask_valid": mask_valid,
        "lane_points": lane_points, "lane_valid": lane_valid, "ego_translation": ego_t,
    }


def small_bucket(dets: dict, mask_cfg: dict) -> bool:
    """Whether a frame's prompts fit the smallest prompt bucket: its busiest
    camera's boxes after the host's class-wise NMS and caps (the
    reference's copy of them, checks.prompts)."""
    from perfbench.checks import prompts

    return prompts(dets, mask_cfg)[0].shape[1] == min(mask_cfg["prompt_buckets"])


def pool_detections(traffic: dict, n_frames: int, mask_cfg: dict,
                    rng: np.random.Generator) -> list:
    """The pool's swapped-in detections, one dict a frame: each camera's
    count uniform over `detections_per_camera`, a frame drawn again until
    its prompt bucket is the one its place in the pool asks for;
    `small_bucket_frames` places, drawn from the seed, ask for the
    smallest bucket."""
    lo, hi = traffic["detections_per_camera"]
    small = set(rng.permutation(n_frames)[:traffic["small_bucket_frames"]].tolist())
    out = []
    for i in range(n_frames):
        while True:
            counts = rng.integers(lo, hi + 1, traffic["cameras"])
            dets = detections(traffic, counts, mask_cfg["max_detections"], rng)
            if small_bucket(dets, mask_cfg) == (i in small):
                break
        out.append(dets)
    return out


def detections(traffic: dict, counts: np.ndarray, max_dets: int,
               rng: np.random.Generator) -> dict:
    """One frame's swapped-in detector output (host arrays, [C, D]):
    xyxy boxes 30-530 px wide and high from corners in [0, 500), scores in
    [0.1, 1), vocabulary ids, the first counts[c] of camera c valid."""
    c = traffic["cameras"]
    lo, hi = traffic["box_corner_px"]
    boxes = rng.uniform(lo, hi, (c, max_dets, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] + traffic["box_min_px"]
    valid = np.arange(max_dets)[None, :] < counts[:, None]
    return {"boxes": boxes,
            "scores": (rng.random((c, max_dets)) * 0.9 + 0.1).astype(np.float32),
            "class_ids": rng.integers(0, len(VOCABULARY), (c, max_dets)),
            "valid": valid}


def blob_planes(traffic: dict, n_words: int, gen: torch.Generator, device) -> torch.Tensor:
    """[W, H, n_words] int32 planes of n_words * 32 blobs (the decoded
    masks' stand-in), each blob_wh px at a seeded place on the canvas."""
    img_h, img_w = traffic["image_hw"]
    bw, bh = traffic["blob_wh"]
    m = n_words * 32
    x0 = torch.randint(0, max(img_w - bw - 30, 1), (m,), generator=gen, device=device)
    y0 = torch.randint(0, max(img_h - bh - 10, 1), (m,), generator=gen, device=device)
    xs = torch.arange(img_w, device=device)[None, :, None]
    ys = torch.arange(img_h, device=device)[None, None, :]
    masks = ((xs >= x0[:, None, None]) & (xs < x0[:, None, None] + bw)
             & (ys >= y0[:, None, None]) & (ys < y0[:, None, None] + bh))
    return pack_planes(masks, n_words)


def images(traffic: dict, gen: torch.Generator, device) -> np.ndarray:
    """[cameras, H, W, 3] uint8 camera images, drawn on the device."""
    h, w = traffic["image_hw"]
    return torch.randint(0, 255, (traffic["cameras"], h, w, 3), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()
