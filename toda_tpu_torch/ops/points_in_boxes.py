"""Points in rotated 3D boxes.

Counterpart of ``toda_tpu/ops/points_in_boxes.py`` (:11-41): a point lies in
a box if, in the box's frame, |x| <= dx/2, |y| <= dy/2 and |z| <= dz/2; a
padding box (zero volume) holds no point. Both functions broadcast over
leading batch dims. ``count_points_in_boxes`` counts the points of each
box a block of boxes at a time, so a batch of 65536-point scans against 128
RoIs each never holds more than a (B, block, P) matrix.
"""

import torch


def points_in_boxes(points, boxes):
    """(..., P, 3+) x (..., M, 7+) -> (..., M, P) bool membership matrix."""
    box = boxes[..., :, None, :]
    dx = points[..., None, :, 0] - box[..., 0]  # (..., M, P)
    dy = points[..., None, :, 1] - box[..., 1]
    dz = points[..., None, :, 2] - box[..., 2]
    cosa, sina = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
    local_x = dx * cosa - dy * sina
    local_y = dx * sina + dy * cosa
    nonzero = box[..., 3] * box[..., 4] * box[..., 5] > 0
    return ((local_x.abs() <= box[..., 3] / 2) & (local_y.abs() <= box[..., 4] / 2)
            & (dz.abs() <= box[..., 5] / 2) & nonzero)


def points_box_id(points, boxes):
    """(..., P, 3+) x (..., M, 7+) -> (..., P) int64 index of the first box
    that holds each point, -1 where none does."""
    member = points_in_boxes(points, boxes)
    first = torch.argmax(member.to(torch.uint8), dim=-2)
    return torch.where(member.any(dim=-2), first, torch.full_like(first, -1))


def count_points_in_boxes(points, points_mask, boxes, block=16):
    """(B, P, 3+) points, (B, P) validity and (B, M, 7+) boxes -> (B, M)
    int64 count of the valid points in each box, ``block`` boxes at a time."""
    mask = points_mask[..., None, :]
    return torch.cat([(points_in_boxes(points, boxes[..., i:i + block, :]) & mask).sum(dim=-1)
                      for i in range(0, boxes.shape[-2], block)], dim=-1)
