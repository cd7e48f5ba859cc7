"""Evaluation harness: predict sweep on the device + host metric computation.

Counterpart of ``toda_tpu/runtime/eval_utils.py`` (``evaluate_target_domain``
:22-48, ``make_predict_step``, ``compute_recall``, ``eval_one_epoch``). In a
data-parallel run each process predicts its rank-strided share of the
frames; ``eval_one_epoch`` then merges the detections back into dataset
order (``commu_utils.merge_results_dist``), sums the recall counters,
averages sec/example over the ranks and computes the dataset metric on rank
0, as JAX's does (:149-170).
"""

import time

import numpy as np

from ..utils import box_utils, commu_utils


def evaluate_target_domain(cfg, weights, batch_size, device, logger=None, dist=False):
    """Evaluate a detector's ``weights`` (a module state dict) on the
    target domain after a TODA stage: ``DATA_CONFIG_TEST`` (else
    ``DATA_CONFIG``), through a bundle built over that dataset on
    ``device`` (the stage's bundle was built over the mix dataset, whose
    grid metadata is not the eval domain's). Returns (result_dict,
    det_annos)."""
    from ..datasets import build_dataloader
    from ..models import build_network

    eval_cfg = cfg.get("DATA_CONFIG_TEST", cfg.DATA_CONFIG)
    ds, loader, _ = build_dataloader(eval_cfg, cfg.CLASS_NAMES, batch_size=batch_size,
                                     dist=dist, training=False, logger=logger)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device)
    bundle.module.load_state_dict(weights, strict=True)
    result, annos = eval_one_epoch(bundle, loader, ds, cfg.CLASS_NAMES, logger=logger)
    if logger:
        logger.info("target-domain eval result: %s", result)
    return result, annos


def make_predict_step(bundle):
    """batch (numpy) -> dict of (B, K) detection tensors on the bundle's device."""

    def predict_step(batch):
        return bundle.predict(bundle.to_device(batch))

    return predict_step


def compute_recall(pred_boxes, pred_mask, gt_boxes, thresh_list, rois=None, roi_mask=None):
    """Per-frame recall counters (host). gt_boxes (M, 8) padded, class id in
    the last column. With ``rois`` (and their mask), the first-stage
    proposals' recall too (``recall_roi_<t>``)."""
    gt_valid = gt_boxes[:, -1] > 0
    gts = gt_boxes[gt_valid][:, :7]
    out = {f"recall_{t}": 0 for t in thresh_list}
    if rois is not None:
        out.update({f"recall_roi_{t}": 0 for t in thresh_list})
    out["gt"] = len(gts)
    if len(gts) == 0:
        return out
    found = [("recall", pred_boxes[pred_mask.astype(bool)][:, :7])]
    if rois is not None:
        found.append(("recall_roi", rois[roi_mask.astype(bool)][:, :7]))
    for key, boxes in found:
        if len(boxes):
            best = box_utils.boxes_bev_iou_cpu(gts, boxes).max(axis=1)
            for t in thresh_list:
                out[f"{key}_{t}"] = int((best > t).sum())
    return out


def _recall_rates(recall, thresh_list, has_rois):
    out = {f"recall/{t}": recall[f"recall_{t}"] / max(recall["gt"], 1) for t in thresh_list}
    if has_rois:
        out.update({f"recall/roi_{t}": recall[f"recall_roi_{t}"] / max(recall["gt"], 1)
                    for t in thresh_list})
    return out


def eval_one_epoch(bundle, loader, dataset, class_names, logger=None, predict_step=None):
    """Predict every batch of ``loader``, then recall and the dataset metric.

    Returns (result_dict, det_annos). result_dict carries the dataset's
    metrics, ``recall/<t>`` (and ``recall/roi_<t>`` when the detections
    carry first-stage RoIs), ``sec_per_example`` (steady state, from the
    second batch on, host clock around device work that ends in a copy to the
    host) and ``compile_sec`` (JAX's name: the first batch's seconds, which
    hold its compile there and the kernels' first launches here). In a
    data-parallel run every rank returns the merged det_annos; rank 0 alone
    computes the dataset metric, the others return the recall rates and the
    timings."""
    predict_step = predict_step or make_predict_step(bundle)
    thresh_list = bundle.post_cfg.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7])
    det_annos = []
    recall = {f"recall_{t}": 0 for t in thresh_list}
    recall.update({f"recall_roi_{t}": 0 for t in thresh_list})
    recall["gt"] = 0
    has_rois = False
    t0 = time.time()
    n_frames = 0
    first_batch_sec = None
    steady_t0, steady_frames = None, 0
    for batch in loader:
        if first_batch_sec is not None and steady_t0 is None:
            steady_t0 = time.time()
        dets = predict_step(batch)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}  # waits for the device
        b = dets["pred_boxes"].shape[0]
        n_frames += b
        if first_batch_sec is None:
            first_batch_sec = time.time() - t0
        else:
            steady_frames += b
        pred_dicts = [
            {k: dets[k][i] for k in ("pred_boxes", "pred_scores", "pred_labels", "pred_mask")}
            for i in range(b)
        ]
        if "gt_boxes" in batch:
            has_rois = has_rois or "rois" in dets
            for i in range(b):
                r = compute_recall(dets["pred_boxes"][i], dets["pred_mask"][i],
                                   np.asarray(batch["gt_boxes"][i]), thresh_list,
                                   rois=dets["rois"][i] if "rois" in dets else None,
                                   roi_mask=dets["roi_mask"][i] if "rois" in dets else None)
                for k in r:
                    recall[k] += r[k]
        det_annos.extend(dataset.generate_prediction_dicts(batch, pred_dicts, class_names))
    if steady_frames > 0:
        sec_per_ex = (time.time() - steady_t0) / steady_frames
    else:
        sec_per_ex = (time.time() - t0) / max(n_frames, 1)
    timings = {"sec_per_example": sec_per_ex, "compile_sec": first_batch_sec or 0.0}

    if commu_utils.get_world_size() > 1:
        det_annos = commu_utils.merge_results_dist(det_annos, len(dataset))
        recall = {k: int(v) for k, v in commu_utils.reduce_dict(recall, average=False).items()}
        timings["sec_per_example"] = commu_utils.average_reduce_value(sec_per_ex)
        if commu_utils.get_rank() != 0:
            return {**_recall_rates(recall, thresh_list, has_rois), **timings}, det_annos

    if logger:
        logger.info("eval: %.4f sec/example steady-state over %d frames "
                    "(first batch: %.1fs)", timings["sec_per_example"], n_frames,
                    timings["compile_sec"])
    result_str, result_dict = dataset.evaluation(det_annos, class_names)
    if logger:
        logger.info("\n%s", result_str)
    result_dict.update(_recall_rates(recall, thresh_list, has_rois))
    result_dict.update(timings)
    return result_dict, det_annos
