"""Anchor-to-gt target assignment of the anchor heads.

The port's own copy of
``toda_tpu/models/dense_heads/target_assigner/axis_aligned_target_assigner.py``:
per-class max-IoU matching on the nearest axis-aligned BEV IoU of one dense
(anchors x gt) matrix with a class mask, each gt force-matched to its best
anchors (ties included), the matched and unmatched thresholds, and
1 / num_pos regression weights. Batched over a leading batch dim instead of
JAX's vmap.
"""

import math

import torch


def nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned nearest BEV IoU (:16-41): (..., N, 7) x (..., M, 7) ->
    (..., N, M). Each box is snapped to the nearer of 0 and 90 degrees."""

    def to_bev(b):
        rot = b[..., 6] - torch.floor(b[..., 6] / math.pi + 0.5) * math.pi
        swap = rot.abs() > math.pi / 4
        dx = torch.where(swap, b[..., 4], b[..., 3])
        dy = torch.where(swap, b[..., 3], b[..., 4])
        return torch.stack([b[..., 0] - dx / 2, b[..., 1] - dy / 2,
                            b[..., 0] + dx / 2, b[..., 1] + dy / 2], dim=-1)

    a = to_bev(boxes_a)[..., :, None, :]
    b = to_bev(boxes_b)[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


class AxisAlignedTargetAssigner:
    """Per-anchor targets of a batch of padded gt boxes (:44-126).

    anchors (N, 7), anchor_classes (N,) 1-based, matched_thr and
    unmatched_thr (N,): tensors on the device the targets are made on."""

    def __init__(self, anchors, anchor_classes, matched_thr, unmatched_thr, box_coder):
        self.anchors = anchors
        self.anchor_classes = anchor_classes
        self.matched_thr = matched_thr
        self.unmatched_thr = unmatched_thr
        self.box_coder = box_coder

    def assign(self, gt_boxes):
        """gt_boxes (B, M, 8): 7 box values, then the class id (0 = padding).

        Returns a dict of per-anchor targets: box_cls_labels (B, N) int32
        (-1 ignored, 0 background, > 0 class id), box_reg_targets (B, N, 7),
        reg_weights (B, N) and matched_gt_heading (B, N)."""
        anchors = self.anchors
        gt_cls = gt_boxes[..., -1].to(torch.int32)  # (B, M)
        gt_valid = gt_cls > 0
        iou = nearest_bev_iou(anchors.expand(gt_boxes.shape[0], -1, -1), gt_boxes[..., :7])
        usable = (self.anchor_classes[None, :, None] == gt_cls[:, None, :]) & gt_valid[:, None, :]
        iou = torch.where(usable, iou, torch.full_like(iou, -1.0))  # (B, N, M)

        anchor_best, anchor_best_gt = iou.max(dim=2)
        gt_best = iou.max(dim=1).values  # (B, M)
        # force match: the anchors that reach a gt's best IoU (ties included)
        best_of_gt = (iou == gt_best[:, None, :]) & gt_valid[:, None, :]
        force = (best_of_gt & (gt_best[:, None, :] > 1e-6)).any(dim=2)
        pos = (anchor_best >= self.matched_thr) | force
        neg = (anchor_best < self.unmatched_thr) & ~pos
        # a force-matched anchor takes the class of the gt it is best for
        # (the first such gt); its regression target stays its own argmax gt
        assigned = torch.where(
            force, torch.where(best_of_gt, iou, torch.full_like(iou, -2.0)).argmax(dim=2),
            anchor_best_gt)
        cls_of = torch.gather(gt_cls, 1, assigned)
        labels = torch.where(pos, cls_of, torch.where(neg, 0, -1)).to(torch.int32)

        matched = torch.gather(gt_boxes[..., :7], 1,
                               anchor_best_gt[..., None].expand(-1, -1, 7))
        reg = self.box_coder.encode(matched, anchors.expand_as(matched))
        reg = torch.where(pos[..., None], reg, torch.zeros_like(reg))
        num_pos = torch.clamp(pos.sum(1, keepdim=True), min=1).to(anchors.dtype)
        return {
            "box_cls_labels": labels,
            "box_reg_targets": reg,
            "reg_weights": torch.where(pos, 1.0 / num_pos, torch.zeros_like(num_pos)),
            "matched_gt_heading": torch.where(pos, matched[..., 6], torch.zeros_like(reg[..., 0])),
        }
