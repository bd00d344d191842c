"""PR / TP curve rendering (reference DetectionEval.render,
src/nuscenes/eval_custom.py:1045-1068, which calls the devkit's
summary_plot / class_pr_curve / class_tp_curve / dist_pr_curve).

Same plots-dir layout and file names as the reference so downstream
tooling finds them: {plot_dir}/summary.pdf, {class}_pr.pdf, {class}_tp.pdf,
dist_pr_{dist_th}.pdf. Rebuilt from scratch on matplotlib (Agg backend —
rendering must work headless).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

TP_LABELS = {
    "trans_err": ("Trans.", "m"),
    "scale_err": ("Scale", "1-IOU"),
    "orient_err": ("Orient.", "rad"),
    "vel_err": ("Vel.", "m/s"),
    "attr_err": ("Attr.", "1-acc"),
}

PRETTY_NAMES = {
    "traffic_cone": "Traffic Cone",
    "construction_vehicle": "Constr. Veh.",
}


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _setup_pr_axis(ax, min_precision: float, min_recall: float, title: str):
    # the devkit draws the FULL curve; the AP integration region is shown
    # only by the dashed min-precision / min-recall threshold lines
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.axhline(min_precision, linestyle="--", color="0.6", linewidth=0.8)
    ax.axvline(min_recall, linestyle="--", color="0.6", linewidth=0.8)


def class_pr_curve(
    metric_data: Dict[Tuple[str, float], "MetricData"],
    metrics,
    detection_name: str,
    min_precision: float,
    min_recall: float,
    savepath: str,
    ax=None,
) -> None:
    """PR curves of one class across every matching distance threshold."""
    plt = _plt()
    own = ax is None
    if own:
        _, ax = plt.subplots(figsize=(6, 5))
    _setup_pr_axis(
        ax, min_precision, min_recall,
        PRETTY_NAMES.get(detection_name, detection_name.title()),
    )
    aps = metrics.label_aps.get(detection_name, {})
    for dist_th in sorted({d for (n, d) in metric_data if n == detection_name}):
        md = metric_data[(detection_name, dist_th)]
        ax.plot(
            np.asarray(md.recall), np.asarray(md.precision),
            label=f"Dist. : {dist_th}, AP: {aps.get(dist_th, 0.0) * 100:.1f}",
        )
    ax.legend(loc="best")
    if own:
        plt.savefig(savepath, bbox_inches="tight")
        plt.close()


def class_tp_curve(
    metric_data: Dict[Tuple[str, float], "MetricData"],
    metrics,
    detection_name: str,
    min_recall: float,
    dist_th_tp: float,
    savepath: str,
    ax=None,
) -> None:
    """TP-error curves (vs recall) of one class at the TP threshold."""
    plt = _plt()
    own = ax is None
    if own:
        _, ax = plt.subplots(figsize=(6, 5))
    md = metric_data[(detection_name, dist_th_tp)]
    rec = np.asarray(md.recall)
    mri = md.max_recall_ind
    errs = metrics.label_tp_errors.get(detection_name, {})
    ylim = 1.0
    for key, (label, unit) in TP_LABELS.items():
        tp = errs.get(key, np.nan)
        curve = np.asarray(getattr(md, key))
        if np.isnan(tp):
            continue  # class excluded from this metric (cone/barrier rules)
        ax.plot(
            rec[: mri + 1], curve[: mri + 1],
            label=f"{label}: {tp:.2f} ({unit})",
        )
        if mri >= 0 and len(curve):
            ylim = max(ylim, float(np.nanmax(curve[: mri + 1])))
    ax.axvline(rec[mri] if len(rec) else 0.0, linestyle="--", color="0.6",
               linewidth=0.8)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Error")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, ylim * 1.05)
    ax.set_title(PRETTY_NAMES.get(detection_name, detection_name.title()))
    ax.legend(loc="best")
    if own:
        plt.savefig(savepath, bbox_inches="tight")
        plt.close()


def dist_pr_curve(
    metric_data: Dict[Tuple[str, float], "MetricData"],
    metrics,
    dist_th: float,
    min_precision: float,
    min_recall: float,
    savepath: str,
) -> None:
    """All classes' PR curves at one matching distance threshold."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7.5, 5))
    _setup_pr_axis(
        ax, min_precision, min_recall, f"Dist. threshold: {dist_th} m"
    )
    for name in sorted({n for (n, d) in metric_data if d == dist_th}):
        md = metric_data[(name, dist_th)]
        ap = metrics.label_aps.get(name, {}).get(dist_th, 0.0)
        ax.plot(
            np.asarray(md.recall), np.asarray(md.precision),
            label=f"{PRETTY_NAMES.get(name, name.title())}: "
                  f"{ap * 100:.1f}%",
        )
    ax.legend(loc="center left", bbox_to_anchor=(1.02, 0.5))
    plt.savefig(savepath, bbox_inches="tight")
    plt.close()


def summary_plot(
    metric_data: Dict[Tuple[str, float], "MetricData"],
    metrics,
    min_precision: float,
    min_recall: float,
    dist_th_tp: float,
    savepath: str,
) -> None:
    """Grid: one row per class, PR curves left, TP curves right."""
    plt = _plt()
    names = sorted({n for (n, _) in metric_data})
    n = len(names)
    fig, axes = plt.subplots(
        n, 2, figsize=(12, 4 * n), squeeze=False
    )
    for i, name in enumerate(names):
        class_pr_curve(
            metric_data, metrics, name, min_precision, min_recall,
            savepath="", ax=axes[i][0],
        )
        class_tp_curve(
            metric_data, metrics, name, min_recall, dist_th_tp,
            savepath="", ax=axes[i][1],
        )
    plt.tight_layout()
    plt.savefig(savepath, bbox_inches="tight")
    plt.close()


def render_curves(
    metric_data: Dict[Tuple[str, float], "MetricData"],
    metrics,
    cfg,
    plot_dir: str,
    object_only: bool = False,
) -> list:
    """Write the reference's full plots-dir layout; returns paths written."""
    os.makedirs(plot_dir, exist_ok=True)

    def savepath(name):
        return os.path.join(plot_dir, name + ".pdf")

    written = []
    names = ["object"] if object_only else list(cfg.class_names)

    summary_plot(
        metric_data, metrics, cfg.min_precision, cfg.min_recall,
        cfg.dist_th_tp, savepath("summary"),
    )
    written.append(savepath("summary"))
    for name in names:
        class_pr_curve(
            metric_data, metrics, name, cfg.min_precision, cfg.min_recall,
            savepath(name + "_pr"),
        )
        class_tp_curve(
            metric_data, metrics, name, cfg.min_recall, cfg.dist_th_tp,
            savepath(name + "_tp"),
        )
        written += [savepath(name + "_pr"), savepath(name + "_tp")]
    for dist_th in cfg.dist_ths:
        dist_pr_curve(
            metric_data, metrics, dist_th, cfg.min_precision,
            cfg.min_recall, savepath("dist_pr_" + str(dist_th)),
        )
        written.append(savepath("dist_pr_" + str(dist_th)))
    return written


def _box_corners_bev(xy, size, yaw):
    """Closed BEV rectangle [5, 2]: size=(w, l) with l along the box x
    axis (nuScenes wlh convention), rotated by yaw, translated to xy.

    Deliberately NOT geometry.boxes.box_corners_bev: that module imports
    jax at top level, and the eval package stays host-only (no device
    backend init from a plotting tool)."""
    w, l = float(size[0]), float(size[1])
    dx, dy = l / 2.0, w / 2.0
    corners = np.array(
        [[dx, dy], [dx, -dy], [-dx, -dy], [-dx, dy], [dx, dy]]
    )
    c, s = np.cos(yaw), np.sin(yaw)
    return corners @ np.array([[c, s], [-s, c]]) + np.asarray(xy)


def visualize_sample(
    gt_boxes,
    pred_boxes,
    sample_token: str,
    ego_translation,
    eval_range: float,
    savepath: str,
    points_xy=None,
    conf_th: float = 0.15,
) -> None:
    """One example-sample BEV (reference plot_examples,
    eval_custom.py:1080-1097 -> devkit visualize_sample): optional lidar
    points gray, GT boxes green, predictions >= conf_th blue, the
    eval-range circle — all ego-centered."""
    from cm3d_tpu_torch.eval.algo import quaternion_yaw

    plt = _plt()
    ex, ey = float(ego_translation[0]), float(ego_translation[1])
    fig, ax = plt.subplots(figsize=(9, 9))
    if points_xy is not None and len(points_xy):
        pts = np.asarray(points_xy, np.float64)
        ax.scatter(pts[:, 0] - ex, pts[:, 1] - ey, c="0.7", s=0.2,
                   linewidths=0)
    th = np.linspace(0, 2 * np.pi, 100)
    ax.plot(eval_range * np.cos(th), eval_range * np.sin(th), color="0.4",
            linewidth=0.8, linestyle="--")
    for box in gt_boxes[sample_token]:
        c = _box_corners_bev(
            (box.translation[0] - ex, box.translation[1] - ey),
            box.size, quaternion_yaw(tuple(box.rotation)),
        )
        ax.plot(c[:, 0], c[:, 1], color="g", linewidth=1.2)
    for box in pred_boxes[sample_token]:
        if box.detection_score < conf_th:
            continue
        c = _box_corners_bev(
            (box.translation[0] - ex, box.translation[1] - ey),
            box.size, quaternion_yaw(tuple(box.rotation)),
        )
        ax.plot(c[:, 0], c[:, 1], color="b", linewidth=1.0)
    lim = eval_range * 1.05
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    ax.set_title(f"{sample_token}\nGT green / pred (score>={conf_th}) blue")
    fig.savefig(savepath, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_examples(
    gt_boxes,
    pred_boxes,
    sample_tokens,
    ego_translations,
    n: int,
    eval_range: float,
    output_dir: str,
    points_provider=None,
) -> list:
    """Reference example-visualization pass (eval_custom.py:1080-1097):
    a random-but-FIXED subset (seed 42, like the reference) of n samples,
    one png per sample under {output_dir}/examples. Returns paths."""
    import random

    # local Random(42): same Mersenne permutation as the reference's global
    # random.seed(42) + shuffle, without mutating global RNG state
    tokens = list(sample_tokens)
    random.Random(42).shuffle(tokens)
    example_dir = os.path.join(output_dir, "examples")
    os.makedirs(example_dir, exist_ok=True)
    written = []
    for token in tokens[:n]:
        path = os.path.join(example_dir, f"{token}.png")
        if token not in ego_translations:
            # defaulting to (0,0,0) would center the plot ~km away from
            # the global-frame boxes and write a silently-empty png
            raise KeyError(
                f"plot_examples: no ego translation for sample {token!r} "
                f"(inconsistent GT: every evaluated sample needs one)"
            )
        visualize_sample(
            gt_boxes, pred_boxes, token, ego_translations[token],
            eval_range, path,
            points_xy=points_provider(token) if points_provider else None,
        )
        written.append(path)
    return written
