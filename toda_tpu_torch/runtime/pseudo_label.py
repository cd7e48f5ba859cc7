"""Pseudo-label generation, plain and with the FGSM input perturbation.

Counterpart of ``toda_tpu/runtime/pseudo_label.py`` (``make_perturb_step``,
``filter_min_points_boxes``, ``generate_pseudo_labels``, ``voxelize_perturb``,
``lookup_voxel_perturb`` :20-197): an inference sweep over the unlabelled
split, per-class score thresholds, and, with the perturbation, eps *
sign(d loss / d points[..., :3]) of the eval-mode detection loss with the
frame's own detections as targets.

The gradient with respect to the raw points runs backward through the whole
detector on the device: the fused convs' dx kernels (K2's, with act=False at
the raw first conv), the voxelizer's K4 (whose VJP is a K6 gather) and K5
(whose VJP is plain). The parameters' ``requires_grad`` is off meanwhile, so
no weight gradient (no dW kernel) runs, as JAX drops the unused cotangents.
"""

import numpy as np
import torch

from ..utils import box_utils
from .eval_utils import make_predict_step


def points_gradient(bundle, batch):
    """(B, N, C) gradient of the eval-mode loss with respect to the points,
    on the bundle's device. ``batch`` (numpy or tensors) holds points,
    points_mask and the target gt_boxes. The parameters' requires_grad is
    off during the backward and restored after."""
    batch = bundle.to_device(batch)
    points = batch["points"].detach().requires_grad_()
    params = [p for p in bundle.module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        total, _ = bundle.loss({**batch, "points": points}, training=False)
        (g,) = torch.autograd.grad(total, points)
    finally:
        for p in params:
            p.requires_grad_(True)
    return g


def make_perturb_step(bundle):
    """perturb(batch) -> (B, N, 3) sign of ``points_gradient``'s xyz
    columns."""

    def perturb(batch):
        return torch.sign(points_gradient(bundle, batch)[..., :3])

    return perturb


def filter_min_points_boxes(boxes, points, min_points):
    """Keep mask of the boxes that hold at least ``min_points`` points."""
    if min_points <= 0 or len(boxes) == 0:
        return np.ones(len(boxes), bool)
    if len(points) == 0:
        return np.zeros(len(boxes), bool)
    return box_utils.points_in_boxes_numpy(points, boxes[:, :7]).sum(axis=1) >= min_points


def generate_pseudo_labels(bundle, loader, dataset, class_names, score_thresh=0.2,
                           with_perturb=False, eps=1.0, min_points=0, logger=None):
    """Sweep ``loader`` (test mode); returns one pseudo info per frame, the
    pool ``MixUpDataset`` reads: {'index', 'gt_boxes' (K, 7), 'gt_names',
    'score'} of the detections that reach their class's threshold (and hold
    ``min_points`` points), and with ``with_perturb`` the per-point
    'point_perturb' (N, 3) = eps * sign(grad) of the frame's padded points
    and its voxel-keyed form 'p_voxel_coords', 'p_voxel_perturb',
    'p_voxel_size', 'p_pc_range'.

    score_thresh: a float or {class name: float}. The perturbation's
    targets are all of the frame's detections, before the threshold."""
    predict_step = make_predict_step(bundle)
    perturb_step = make_perturb_step(bundle) if with_perturb else None
    if not isinstance(score_thresh, dict):
        score_thresh = {c: float(score_thresh) for c in class_names}
    thresh_arr = np.asarray([score_thresh[c] for c in class_names], dtype=np.float32)

    pseudo_infos = []
    for batch in loader:
        arrays = {"points": batch["points"], "points_mask": batch["points_mask"]}
        dets = {k: v.cpu().numpy() for k, v in predict_step(arrays).items()}
        b = dets["pred_boxes"].shape[0]

        perturb = None
        if with_perturb:
            gt_like = np.zeros_like(np.asarray(batch["gt_boxes"]))
            for i in range(b):
                sel = np.where(dets["pred_mask"][i].astype(bool))[0][:gt_like.shape[1]]
                gt_like[i, :len(sel), :7] = dets["pred_boxes"][i, sel, :7]
                gt_like[i, :len(sel), -1] = dets["pred_labels"][i, sel]  # class: last column
            perturb = perturb_step({**arrays, "gt_boxes": gt_like}).cpu().numpy() * eps

        for i in range(b):
            m = dets["pred_mask"][i].astype(bool)
            boxes = dets["pred_boxes"][i][m]
            scores = dets["pred_scores"][i][m]
            labels = dets["pred_labels"][i][m].astype(int)
            keep = scores >= thresh_arr[np.clip(labels - 1, 0, len(class_names) - 1)]
            pts_i = np.asarray(batch["points"][i])[np.asarray(batch["points_mask"][i]).astype(bool)]
            if min_points > 0:
                keep &= filter_min_points_boxes(boxes, pts_i, min_points)
            info = {
                "index": batch["frame_id"][i] if "frame_id" in batch else i,
                "gt_boxes": boxes[keep][:, :7],
                "gt_names": np.asarray([class_names[lab - 1] for lab in labels[keep]]),
                "score": scores[keep],
            }
            if perturb is not None:
                info["point_perturb"] = perturb[i]
                mask_i = np.asarray(batch["points_mask"][i]).astype(bool)
                info["p_voxel_coords"], info["p_voxel_perturb"] = voxelize_perturb(
                    pts_i, perturb[i][mask_i], info["gt_boxes"],
                    voxel_size=dataset.voxel_size, pc_range=dataset.point_cloud_range)
                info["p_voxel_size"] = np.asarray(dataset.voxel_size, np.float32)
                info["p_pc_range"] = np.asarray(dataset.point_cloud_range, np.float32)
            pseudo_infos.append(info)
    if logger:
        logger.info("pseudo labels: %d frames, %d boxes", len(pseudo_infos),
                    sum(len(p["gt_boxes"]) for p in pseudo_infos))
    return pseudo_infos


def _voxel_keys(ijk):
    return (ijk[:, 2] * (1 << 20) + ijk[:, 1]) * (1 << 20) + ijk[:, 0]


def voxelize_perturb(points, point_perturb, pseudo_boxes, voxel_size, pc_range):
    """The mean perturbation of the points inside the pseudo boxes, per
    voxel cell: (p_voxel_coords (V, 3) int32 (x, y, z), p_voxel_perturb
    (V, 3) f32), so a resampled frame can look its points' perturbation up
    by cell."""
    empty = np.zeros((0, 3), np.int32), np.zeros((0, 3), np.float32)
    if len(pseudo_boxes) == 0 or len(points) == 0:
        return empty
    member = box_utils.points_in_boxes_numpy(points, pseudo_boxes[:, :7]).any(axis=0)
    pts = points[member]
    per = np.asarray(point_perturb)[member][:, :3]
    if len(pts) == 0:
        return empty
    vs = np.asarray(voxel_size, np.float32)
    origin = np.asarray(pc_range[:3], np.float32)
    ijk = np.floor((pts[:, :3] - origin) / vs).astype(np.int64)
    in_grid = (ijk >= 0).all(axis=1) & (ijk < (1 << 20)).all(axis=1)
    ijk, per = ijk[in_grid], per[in_grid]
    if len(ijk) == 0:
        return empty
    uniq, inv = np.unique(_voxel_keys(ijk), return_inverse=True)
    sums = np.zeros((len(uniq), 3), np.float32)
    np.add.at(sums, inv, per)
    mean = sums / np.bincount(inv, minlength=len(uniq)).astype(np.float32)[:, None]
    coords = np.stack([uniq % (1 << 20), (uniq >> 20) % (1 << 20), uniq >> 40],
                      axis=1).astype(np.int32)
    return coords, mean


def lookup_voxel_perturb(points, info):
    """(N, 3+) points -> (N, 3) perturbation looked up by voxel cell, zero
    where the info's voxels do not cover a point."""
    vc = np.asarray(info["p_voxel_coords"], np.int64)
    vp = np.asarray(info["p_voxel_perturb"], np.float32)
    if len(vc) == 0:
        return np.zeros((len(points), 3), np.float32)
    vs = np.asarray(info["p_voxel_size"], np.float32)
    origin = np.asarray(info["p_pc_range"][:3], np.float32)
    key = _voxel_keys(np.floor((points[:, :3] - origin) / vs).astype(np.int64))
    vkey = _voxel_keys(vc)
    order = np.argsort(vkey)
    vkey_sorted = vkey[order]
    pos = np.clip(np.searchsorted(vkey_sorted, key), 0, len(vkey_sorted) - 1)
    hit = vkey_sorted[pos] == key
    out = np.zeros((len(points), 3), np.float32)
    out[hit] = vp[order][pos[hit]]
    return out
