"""Rotated BEV NMS with static output sizes, batched.

Counterpart of ``toda_tpu/ops/nms.py`` (``nms_bev``, ``class_agnostic_nms``).
Top-K by score, one (K, K) rotated-IoU matrix, then greedy suppression as a
fixed point: keep[i] = alive[i] & ~any_{j<i}(iou[j, i] > thresh & keep[j]).
Iterating from keep = alive reaches the sequential greedy result after at most
the longest suppression chain. Ties in score rank the lower index first, as
``jax.lax.top_k`` does.
"""

import torch

from .rotated_iou import boxes_iou_bev

NEG_INF = -1e9


def top_k(x, k):
    """(values, indices) of the k largest along the last dim; equal values
    keep index order (stable), like jax.lax.top_k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_bev(boxes, scores, thresh, pre_maxsize=1024, post_maxsize=512, valid_mask=None):
    """Greedy rotated-BEV NMS.

    Args:
        boxes: (B, N, 7); scores: (B, N); valid_mask: optional (B, N) bool.
    Returns keep_idx (B, post_maxsize) int64 row indices and keep_mask
    (B, post_maxsize) bool (which slots are real detections).
    """
    n = boxes.shape[-2]
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, torch.full_like(scores, NEG_INF))
    k = min(pre_maxsize, n)
    top_scores, order = top_k(scores, k)
    top_boxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    iou = boxes_iou_bev(top_boxes, top_boxes)
    alive = top_scores > NEG_INF / 2
    ranks = torch.arange(k, device=boxes.device)
    sup = (iou > thresh) & (ranks[:, None] < ranks[None, :])
    keep = alive
    for _ in range(k):
        new = alive & ~torch.any(sup & keep[..., :, None], dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    sel_scores = torch.where(keep, top_scores, torch.full_like(top_scores, NEG_INF))
    kk = min(post_maxsize, k)
    _, sel = top_k(sel_scores, kk)
    keep_idx = torch.gather(order, -1, sel)
    keep_mask = torch.gather(keep, -1, sel)
    if kk < post_maxsize:
        pad = post_maxsize - kk
        keep_idx = torch.nn.functional.pad(keep_idx, (0, pad))
        keep_mask = torch.nn.functional.pad(keep_mask, (0, pad))
    return keep_idx, keep_mask


def class_agnostic_nms(box_scores, box_preds, score_thresh=None, nms_thresh=0.2,
                       pre_maxsize=1024, post_maxsize=512):
    """Score threshold + NMS (``toda_tpu/ops/nms.py`` class_agnostic_nms).
    box_scores (B, N), box_preds (B, N, 7) -> (keep_idx, keep_mask)."""
    mask = None if score_thresh is None else box_scores >= score_thresh
    return nms_bev(box_preds, box_scores, nms_thresh, pre_maxsize, post_maxsize, mask)
