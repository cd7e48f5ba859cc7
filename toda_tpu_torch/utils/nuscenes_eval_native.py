"""Native (devkit-free) nuScenes-protocol detection metrics: mAP + official NDS.

The port's own copy of ``toda_tpu/utils/nuscenes_eval_native.py``: the
official protocol in numpy, following the devkit algorithm
(nuscenes/eval/detection/algo.py + evaluate.py):

  * per (class, threshold) accumulation: detections sorted by score across all
    frames, greedy match to the closest unmatched same-class GT by BEV center
    distance at thresholds {0.5, 1, 2, 4} m;
  * precision interpolated onto the 101-point recall grid with np.interp
    (NOT the PASCAL max-envelope), AP = mean(clip(prec - 0.1, 0)) / 0.9 over
    the recall > 0.1 region;
  * five TP errors at the 2 m threshold — ATE (BEV center L2), ASE (1 - IoU of
    pose-aligned boxes), AOE (yaw diff, period pi for 'barrier'), AVE (L2 of
    (vx, vy) from box columns 7:9), AAE (1 - attribute accuracy) — each as the
    devkit's cumulative mean interpolated over confidence onto the recall grid
    and averaged over [min_recall_index + 1 : max_recall_index];
  * devkit class exclusions: 'traffic_cone' has no AOE/AVE/AAE, 'barrier' has
    no AVE/AAE (excluded from the per-metric class mean, nanmean);
  * NDS = (5 * mAP + sum_5 max(0, 1 - mTP)) / 10.

Lidar-only fallback convention (documented): when detections or GT carry no
velocity columns (7-col boxes) or no attribute arrays, that metric's error is
1.0 — contributing 0 to NDS, i.e. NDS is a LOWER BOUND on the devkit value,
never an overstatement. Attribute arrays are read from anno key 'attribute'
(or 'attribute_name'); empty-string GT attributes are skipped like the devkit.
"""

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
NELEM = 101  # devkit recall grid resolution
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# devkit evaluate.py class exclusions
_EXCLUDE = {
    "traffic_cone": {"attr_err", "vel_err", "orient_err"},
    "barrier": {"attr_err", "vel_err"},
}


def _scale_iou(det_box, gt_box):
    """IoU of pose-aligned (size-only) boxes — devkit common/utils.scale_iou."""
    a = np.minimum(det_box[3:6], gt_box[3:6])
    inter = np.prod(a)
    union = np.prod(det_box[3:6]) + np.prod(gt_box[3:6]) - inter
    return inter / max(union, 1e-6)


def _angle_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return float(min(d, period - d))


def _cummean(x):
    """Devkit common/utils.cummean: NaN-aware cumulative mean."""
    x = np.asarray(x, dtype=np.float64)
    valid = ~np.isnan(x)
    if valid.sum() == 0:
        return np.ones(len(x))
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.nancumsum(x) / np.maximum(np.cumsum(valid), 1e-9)
    return out


def _get_attr(anno, mask):
    for key in ("attribute", "attribute_name"):
        if key in anno:
            return np.asarray(anno[key])[mask]
    return None


def accumulate_class(det_annos, gt_annos, class_name, dist_th):
    """Devkit algo.accumulate: returns the per-(class, threshold) MetricData dict
    {precision, confidence, <tp metrics>} on the 101-point recall grid, or None
    when the class has no GT (devkit skips such classes from every mean)."""
    gt_per_frame, gt_vel, gt_attr = [], [], []
    total_gt = 0
    for gt in gt_annos:
        m = np.asarray(gt["name"]) == class_name
        boxes = np.asarray(gt["boxes_lidar"], dtype=np.float64)
        if boxes.ndim != 2:
            boxes = boxes.reshape(-1, 7)
        boxes = boxes[m]
        gt_per_frame.append(boxes)
        gt_vel.append(boxes[:, 7:9] if boxes.shape[1] >= 9 else None)
        gt_attr.append(_get_attr(gt, m))
        total_gt += len(boxes)
    if total_gt == 0:
        return None

    dets = []  # (score, frame, box, attr)
    for f, det in enumerate(det_annos):
        m = np.asarray(det["name"]) == class_name
        boxes = np.asarray(det["boxes_lidar"], dtype=np.float64)
        if boxes.ndim != 2:
            boxes = boxes.reshape(-1, 7)
        boxes = boxes[m]
        scores = np.asarray(det["score"])[m]
        attrs = _get_attr(det, m)
        for i, (b, s) in enumerate(zip(boxes, scores)):
            dets.append((float(s), f, b, attrs[i] if attrs is not None else None))
    md = {
        "precision": np.zeros(NELEM),
        "confidence": np.zeros(NELEM),
        **{k: np.ones(NELEM) for k in TP_METRICS},
    }
    if not dets:
        return md

    dets.sort(key=lambda x: -x[0])
    taken = [np.zeros(len(g), bool) for g in gt_per_frame]
    tp, fp, conf = [], [], []
    match = {k: [] for k in TP_METRICS}
    match_conf = []
    period = np.pi if class_name == "barrier" else 2 * np.pi
    for s, f, box, attr in dets:
        gts = gt_per_frame[f]
        is_match = False
        if len(gts):
            d = np.linalg.norm(gts[:, :2] - box[:2], axis=1)
            d = np.where(taken[f], np.inf, d)
            j = int(np.argmin(d))
            is_match = d[j] < dist_th
        if is_match:
            taken[f][j] = True
            tp.append(1); fp.append(0); conf.append(s)
            match["trans_err"].append(d[j])
            match["scale_err"].append(1.0 - _scale_iou(box, gts[j]))
            match["orient_err"].append(_angle_diff(box[6], gts[j][6], period))
            if gt_vel[f] is not None and box.shape[0] >= 9:
                match["vel_err"].append(float(np.linalg.norm(box[7:9] - gt_vel[f][j])))
            else:
                match["vel_err"].append(1.0)  # lidar-only fallback (see module doc)
            ga = gt_attr[f][j] if gt_attr[f] is not None else None
            if ga is None or attr is None:
                match["attr_err"].append(1.0)  # fallback
            elif str(ga) == "":
                match["attr_err"].append(np.nan)  # devkit skips unattributed GT
            else:
                match["attr_err"].append(1.0 - float(str(attr) == str(ga)))
            match_conf.append(s)
        else:
            tp.append(0); fp.append(1); conf.append(s)

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / (tp + fp)
    rec = tp / total_gt

    rec_interp = np.linspace(0, 1, NELEM)
    md["precision"] = np.interp(rec_interp, rec, prec, right=0)
    md["confidence"] = np.interp(rec_interp, rec, conf, right=0)
    if match_conf:
        for k in TP_METRICS:
            tmp = _cummean(match[k])
            # interp over confidence (descending -> reversed), devkit algo.py
            md[k] = np.interp(
                md["confidence"][::-1], np.asarray(match_conf)[::-1], tmp[::-1]
            )[::-1]
    return md


def calc_ap(md):
    """Devkit algo.calc_ap."""
    prec = np.copy(md["precision"])
    prec = prec[round(100 * MIN_RECALL) + 1 :]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md, metric_name):
    """Devkit algo.calc_tp: mean over the achieved-recall span of the grid."""
    first_ind = round(100 * MIN_RECALL) + 1
    nonzero = np.nonzero(md["confidence"])[0]
    last_ind = int(nonzero[-1]) if len(nonzero) else 0
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric_name][first_ind : last_ind + 1]))


def nuscenes_eval(det_annos, gt_annos, class_names):
    """Returns (result_str, result_dict) with per-class AP, mAP, mTP errors, NDS."""
    result = {}
    aps = []
    tp_err_acc = {k: [] for k in TP_METRICS}
    for cls in class_names:
        cls_aps = []
        for th in DIST_THRESHOLDS:
            md = accumulate_class(det_annos, gt_annos, cls, th)
            ap = calc_ap(md) if md is not None else 0.0
            cls_aps.append(ap)
            result[f"AP_{cls}@{th}"] = ap
            if th == TP_THRESHOLD:
                for k in TP_METRICS:
                    if k in _EXCLUDE.get(cls, ()):
                        err = np.nan
                    elif md is None:
                        err = np.nan
                    else:
                        err = calc_tp(md, k)
                    tp_err_acc[k].append(err)
        result[f"AP_{cls}"] = float(np.mean(cls_aps))
        aps.append(np.mean(cls_aps))
    mean_ap = float(np.mean(aps)) if aps else 0.0
    result["mAP"] = mean_ap

    tp_scores = []
    for k, vals in tp_err_acc.items():
        vals = np.asarray(vals, dtype=np.float64)
        err = float(np.nanmean(vals)) if np.any(~np.isnan(vals)) else 1.0
        result[f"m{k.upper()}"] = err
        tp_scores.append(max(0.0, 1.0 - min(1.0, err)))
    # official NDS (devkit DetectionMetrics.nd_score, mean_ap_weight = 5)
    nds = (5.0 * mean_ap + sum(tp_scores)) / (5.0 + len(TP_METRICS))
    result["NDS"] = float(nds)
    lines = [f"{k}: {v:.4f}" for k, v in sorted(result.items())]
    return "\n".join(lines), result
