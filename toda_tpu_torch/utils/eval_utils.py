"""Generic detection mAP evaluation (host numpy) — the hermetic metric backend.

Real-dataset metric backends (nuScenes NDS, KITTI 40-point AP, Waymo APH) live in
their dataset packages; this module provides the dataset-agnostic AP machinery they
and the synthetic fixture share. Matching uses exact rotated BEV IoU.
"""

import numpy as np

from . import box_utils


def _ap_from_pr(recall, precision, num_sample_pts=40):
    """N-point interpolated AP (KITTI-style 40-point)."""
    ap = 0.0
    for t in np.linspace(0, 1, num_sample_pts):
        prec = precision[recall >= t]
        ap += (prec.max() if len(prec) else 0.0) / num_sample_pts
    return ap


def eval_class(det_annos, gt_annos, class_name, iou_thresh=0.5):
    """AP for one class over a list of frames.

    det_annos/gt_annos: per-frame dicts with 'boxes_lidar' (N, 7+) and 'name' (N,),
    dets also carry 'score'.
    """
    scores, tps = [], []
    total_gt = 0
    for det, gt in zip(det_annos, gt_annos):
        gt_mask = np.asarray(gt["name"]) == class_name
        gt_boxes = np.asarray(gt["boxes_lidar"])[gt_mask][:, :7]
        total_gt += len(gt_boxes)
        det_mask = np.asarray(det["name"]) == class_name
        det_boxes = np.asarray(det["boxes_lidar"])[det_mask][:, :7]
        det_scores = np.asarray(det["score"])[det_mask]
        if len(det_boxes) == 0:
            continue
        order = np.argsort(-det_scores)
        det_boxes, det_scores = det_boxes[order], det_scores[order]
        if len(gt_boxes) == 0:
            scores.extend(det_scores)
            tps.extend([0] * len(det_scores))
            continue
        iou = box_utils.boxes_bev_iou_cpu(det_boxes, gt_boxes)
        taken = np.zeros(len(gt_boxes), dtype=bool)
        for i in range(len(det_boxes)):
            j = int(np.argmax(np.where(taken, -1.0, iou[i])))
            if iou[i, j] >= iou_thresh and not taken[j]:
                taken[j] = True
                tps.append(1)
            else:
                tps.append(0)
            scores.append(det_scores[i])
    if total_gt == 0:
        return 0.0
    if not scores:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(tps)[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1 - tp)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    return _ap_from_pr(recall, precision)


def eval_map(det_annos, gt_annos, class_names, iou_thresh=0.5):
    ap_dict = {}
    aps = []
    for cls in class_names:
        ap = eval_class(det_annos, gt_annos, cls, iou_thresh)
        ap_dict[f"AP_{cls}@{iou_thresh}"] = ap
        aps.append(ap)
    ap_dict["mAP"] = float(np.mean(aps)) if aps else 0.0
    return ap_dict
