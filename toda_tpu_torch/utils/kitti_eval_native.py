"""The official KITTI AP (40 recall positions) and AOS, in numpy.

The port's own copy of ``toda_tpu/utils/kitti_eval_native.py``: the
per-difficulty ignore rules of ``clean_frame`` (occlusion, truncation and
2D-box height; Van counts as Car's neighbour, Person_sitting as
Pedestrian's), the 41 recall-spaced score thresholds, the greedy per-frame
matcher with ignored detections and DontCare absorption (the image-box
metric), and the table of bbox / bev / 3d AP_R40 per class and difficulty,
with AOS where the detections carry alpha. Its lidar IoUs come from the
port's ``boxes_iou_bev`` / ``boxes_iou3d`` on the CPU. A frame without image
metadata takes its difficulty from a per-box 'difficulty' label, or counts
every box.
"""

import numpy as np

CLASS_ALIASES = {"car": ["van"], "pedestrian": ["person_sitting"]}
MIN_HEIGHT = [40.0, 25.0, 25.0]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
# min overlaps per metric (bbox, bev, 3d) — the standard "hard" thresholds row
MIN_OVERLAPS = {
    "car": (0.7, 0.7, 0.7),
    "pedestrian": (0.5, 0.5, 0.5),
    "cyclist": (0.5, 0.5, 0.5),
    "van": (0.7, 0.7, 0.7),
    "truck": (0.7, 0.7, 0.7),
}
METRIC_COL = {"bbox": 0, "bev": 1, "3d": 2}


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """(N, 4) x (M, 4) [x1,y1,x2,y2] -> overlap matrix. criterion -1: IoU,
    0: intersection / area(box), 1: intersection / area(query)."""
    n, m = len(boxes), len(query_boxes)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    b = np.asarray(boxes, np.float32)
    q = np.asarray(query_boxes, np.float32)
    ix = np.maximum(
        0.0,
        np.minimum(b[:, None, 2], q[None, :, 2]) - np.maximum(b[:, None, 0], q[None, :, 0]),
    )
    iy = np.maximum(
        0.0,
        np.minimum(b[:, None, 3], q[None, :, 3]) - np.maximum(b[:, None, 1], q[None, :, 1]),
    )
    inter = ix * iy
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[:, None]
    area_q = ((q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1]))[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return inter / np.maximum(denom, 1e-9)


def _lidar_overlap(det_boxes, gt_boxes, metric):
    """(D, G) rotated BEV or 3D IoU, f32 on the CPU."""
    import torch

    from ..ops.rotated_iou import boxes_iou3d, boxes_iou_bev

    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)), np.float32)
    fn = boxes_iou_bev if metric == "bev" else boxes_iou3d
    with torch.no_grad():
        return fn(torch.as_tensor(np.asarray(det_boxes[:, :7], np.float32)),
                  torch.as_tensor(np.asarray(gt_boxes[:, :7], np.float32))).numpy()


def clean_frame(gt, dt, cls_name, difficulty):
    """Official clean_data: per-frame gt/det ignore classification.

    Returns (num_valid_gt, ignored_gt (G,), ignored_dt (D,), dc_bboxes).
    ignored codes: 0 counted, 1 ignored-but-absorbing, -1 excluded.
    """
    cls_name = str(cls_name).lower()
    gt_names = np.asarray([str(s).lower() for s in gt["name"]])
    num_gt = len(gt_names)
    bbox = np.asarray(gt.get("bbox", np.zeros((num_gt, 4), np.float32))).reshape(-1, 4)
    has_meta = "bbox" in gt and "occluded" in gt
    if has_meta:
        height = bbox[:, 3] - bbox[:, 1]
        occl = np.asarray(gt["occluded"], np.float32)
        trunc = np.asarray(gt["truncated"], np.float32)
        ignore = (
            (occl > MAX_OCCLUSION[difficulty])
            | (trunc > MAX_TRUNCATION[difficulty])
            | (height <= MIN_HEIGHT[difficulty])
        )
    else:
        # fixtures without image metadata: optional per-box difficulty label
        diff = np.asarray(gt.get("difficulty", np.zeros(num_gt, np.int32)))
        ignore = (diff > difficulty) | (diff < 0)

    ignored_gt = np.full(num_gt, -1, np.int32)
    same = gt_names == cls_name
    neighbor = np.isin(gt_names, CLASS_ALIASES.get(cls_name, []))
    ignored_gt[same & ~ignore] = 0
    ignored_gt[(same & ignore) | neighbor] = 1
    num_valid_gt = int((ignored_gt == 0).sum())
    dc_boxes = bbox[gt_names == "dontcare"] if has_meta else np.zeros((0, 4), np.float32)

    dt_names = np.asarray([str(s).lower() for s in dt["name"]])
    num_dt = len(dt_names)
    ignored_dt = np.full(num_dt, -1, np.int32)
    if num_dt:
        if has_meta and "bbox" in dt:
            dt_height = np.abs(
                np.asarray(dt["bbox"], np.float32).reshape(-1, 4)[:, 3]
                - np.asarray(dt["bbox"], np.float32).reshape(-1, 4)[:, 1]
            )
        else:
            dt_height = np.full(num_dt, 1e4, np.float32)
        ignored_dt[dt_names == cls_name] = 0
        ignored_dt[dt_height < MIN_HEIGHT[difficulty]] = 1
    return num_valid_gt, ignored_gt, ignored_dt, dc_boxes


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    """Score thresholds at ~evenly spaced recall positions (official)."""
    scores = np.sort(np.asarray(scores))[::-1]
    out, current_recall = [], 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and i < len(scores) - 1:
            continue
        out.append(s)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return out


def compute_statistics(
    overlaps, dt_scores, ignored_gt, ignored_dt, dc_overlap,
    min_overlap, thresh=0.0, compute_fp=False,
    dt_alphas=None, gt_alphas=None,
):
    """Greedy per-frame matcher (official compute_statistics_jit semantics).

    overlaps: (D, G); dc_overlap: (D, n_dc) image-criterion-0 overlaps (bbox
    metric only, else empty). Returns (tp, fp, fn, similarity_sum, tp_scores).
    """
    compute_aos = dt_alphas is not None
    D, G = overlaps.shape
    assigned = np.zeros(D, bool)
    ignored_threshold = (np.asarray(dt_scores) < thresh) if compute_fp else np.zeros(D, bool)
    NO_DET = -10_000_000.0
    tp = fp = fn = 0
    similarity = 0.0
    tp_scores = []
    delta = []
    for i in range(G):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_det = NO_DET
        max_ov = 0.0
        assigned_ignored = False
        for j in range(D):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            ov = overlaps[j, i]
            if not compute_fp:
                if ov > min_overlap and dt_scores[j] > valid_det:
                    det_idx, valid_det = j, dt_scores[j]
            elif ov > min_overlap and (ov > max_ov or assigned_ignored) and ignored_dt[j] == 0:
                max_ov, det_idx, valid_det, assigned_ignored = ov, j, 1.0, False
            elif ov > min_overlap and valid_det == NO_DET and ignored_dt[j] == 1:
                det_idx, valid_det, assigned_ignored = j, 1.0, True
        if valid_det == NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif valid_det != NO_DET and (ignored_gt[i] == 1 or ignored_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_det != NO_DET:
            tp += 1
            tp_scores.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(D):
            if not (assigned[j] or ignored_dt[j] in (-1, 1) or ignored_threshold[j]):
                fp += 1
        # DontCare absorption (bbox metric): unmatched dets inside DC regions
        nstuff = 0
        if dc_overlap.shape[1]:
            for j in range(D):
                if assigned[j] or ignored_dt[j] != 0 or ignored_threshold[j]:
                    continue
                if dc_overlap[j].max() > min_overlap:
                    nstuff += 1
                    assigned[j] = True
        fp -= nstuff
        if compute_aos:
            similarity = float(np.sum((1.0 + np.cos(np.asarray(delta))) / 2.0)) if delta else 0.0
    return tp, fp, fn, similarity, tp_scores


def eval_class(gt_annos, dt_annos, cls_name, difficulty, metric, compute_aos=False):
    """AP_R40 (and AOS_R40) for one (class, difficulty, metric)."""
    cls_name = cls_name.lower()
    min_overlap = MIN_OVERLAPS.get(cls_name, (0.5, 0.5, 0.5))[METRIC_COL[metric]]
    frames = []
    total_valid_gt = 0
    all_tp_scores = []
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid, ign_gt, ign_dt, dc = clean_frame(gt, dt, cls_name, difficulty)
        total_valid_gt += num_valid
        g_boxes = np.asarray(gt.get("boxes_lidar", np.zeros((len(ign_gt), 7))))
        d_boxes = np.asarray(dt.get("boxes_lidar", np.zeros((len(ign_dt), 7))))
        d_scores = np.asarray(dt.get("score", np.zeros(len(ign_dt))), np.float32)
        if metric == "bbox":
            ov = image_box_overlap(
                np.asarray(dt.get("bbox", np.zeros((len(ign_dt), 4)))),
                np.asarray(gt.get("bbox", np.zeros((len(ign_gt), 4)))),
            )
            dc_ov = image_box_overlap(
                np.asarray(dt.get("bbox", np.zeros((len(ign_dt), 4)))), dc, criterion=0
            )
        else:
            ov = _lidar_overlap(d_boxes, g_boxes, metric)
            dc_ov = np.zeros((len(ign_dt), 0), np.float32)
        d_alpha = np.asarray(dt["alpha"], np.float32) if compute_aos and "alpha" in dt else None
        g_alpha = np.asarray(gt["alpha"], np.float32) if compute_aos and "alpha" in gt else None
        if compute_aos and (d_alpha is None or g_alpha is None):
            d_alpha = g_alpha = None
        frames.append((ov, d_scores, ign_gt, ign_dt, dc_ov, d_alpha, g_alpha))
        _, _, _, _, tps = compute_statistics(
            ov, d_scores, ign_gt, ign_dt, dc_ov, min_overlap, compute_fp=False
        )
        all_tp_scores.extend(tps)

    if total_valid_gt == 0:
        return {"ap": 0.0, "aos": 0.0}
    thresholds = get_thresholds(all_tp_scores, total_valid_gt)
    pr = np.zeros((len(thresholds), 4))  # tp, fp, fn, similarity
    for ti, t in enumerate(thresholds):
        for ov, d_scores, ign_gt, ign_dt, dc_ov, d_alpha, g_alpha in frames:
            tp, fp, fn, sim, _ = compute_statistics(
                ov, d_scores, ign_gt, ign_dt, dc_ov, min_overlap,
                thresh=t, compute_fp=True,
                dt_alphas=d_alpha, gt_alphas=g_alpha,
            )
            pr[ti] += [tp, fp, fn, sim]
    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for ti in range(len(thresholds)):
        denom = max(pr[ti, 0] + pr[ti, 1], 1e-9)
        precision[ti] = pr[ti, 0] / denom
        aos[ti] = pr[ti, 3] / denom
    # right-max smoothing then R40 average over positions 1..40
    for i in range(N_SAMPLE_PTS - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
        aos[i] = max(aos[i], aos[i + 1])
    return {
        "ap": float(precision[1:].sum() / 40.0),
        "aos": float(aos[1:].sum() / 40.0),
    }


def kitti_eval(det_annos, gt_annos, class_names, difficulties=(0, 1, 2)):
    """Returns (result_str, dict): AP_R40 per class x metric x difficulty, plus
    bbox AP and AOS when the annos carry image boxes / alphas."""
    have_bbox = any(len(g.get("bbox", [])) > 0 for g in gt_annos) and any(
        len(d.get("bbox", [])) > 0 for d in det_annos
    )
    have_alpha = any(len(d.get("alpha", [])) > 0 for d in det_annos)
    metrics = (["bbox"] if have_bbox else []) + ["bev", "3d"]
    result = {}
    for cls in class_names:
        for metric in metrics:
            for d, dname in zip(difficulties, ("easy", "moderate", "hard")):
                r = eval_class(
                    gt_annos, det_annos, cls, d, metric,
                    compute_aos=(metric == "bbox" and have_alpha),
                )
                result[f"{cls}_{metric}_{dname}_R40"] = r["ap"]
                if metric == "bbox" and have_alpha:
                    result[f"{cls}_aos_{dname}_R40"] = r["aos"]
    mods = [v for k, v in result.items() if k.endswith("3d_moderate_R40")]
    result["mAP_3d_moderate"] = float(np.mean(mods)) if mods else 0.0
    lines = [f"{k}: {v:.4f}" for k, v in sorted(result.items())]
    return "\n".join(lines), result
