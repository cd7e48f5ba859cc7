"""Host-side (numpy) 3D box geometry.

The port's own copy of the parts of ``toda_tpu/utils/box_utils.py`` that the
synthetic scenes, the training data path, recall and mAP use. Box convention:
``(x, y, z, dx, dy, dz, heading[, ...])``, (x, y, z) the box centre, heading
the yaw around +z (counter-clockwise, 0 = +x axis).
"""

import numpy as np

from . import common_utils


def boxes_to_corners_3d(boxes3d):
    """(N, 7) -> (N, 8, 3) corner points (bottom face 0-3, top face 4-7)."""
    boxes3d = np.asarray(boxes3d)
    template = np.array(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], dtype=np.float32) / 2.0
    corners3d = boxes3d[:, None, 3:6] * template[None, :, :]
    corners3d = common_utils.rotate_points_along_z(corners3d, boxes3d[:, 6])
    corners3d += boxes3d[:, None, 0:3]
    return corners3d


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """Keep boxes with >= min_num_corners corners inside ``limit_range``."""
    if boxes.shape[1] > 7:
        boxes = boxes[:, :7]
    corners = boxes_to_corners_3d(boxes)
    mask = ((corners >= limit_range[0:3]) & (corners <= limit_range[3:6])).all(axis=2)
    return mask.sum(axis=1) >= min_num_corners


def corners_bev(boxes):
    """(N, 7+) -> (N, 4, 2) BEV corner polygon (counter-clockwise)."""
    boxes = np.asarray(boxes)
    template = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], dtype=np.float32) / 2.0
    corners = boxes[:, None, 3:5] * template[None]
    cosa, sina = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = corners[..., 0] * cosa[:, None] - corners[..., 1] * sina[:, None]
    y = corners[..., 0] * sina[:, None] + corners[..., 1] * cosa[:, None]
    return np.stack([x + boxes[:, None, 0], y + boxes[:, None, 1]], axis=-1)


def _polygon_clip(subject, clip_poly):
    """Sutherland–Hodgman clip of polygon ``subject`` (V, 2) by convex ``clip_poly``."""
    out = list(subject)
    n_clip = len(clip_poly)
    for i in range(n_clip):
        a = clip_poly[i]
        b = clip_poly[(i + 1) % n_clip]
        edge = (b[0] - a[0], b[1] - a[1])
        inp = out
        out = []
        if not inp:
            break
        for j in range(len(inp)):
            p = inp[j]
            q = inp[(j + 1) % len(inp)]
            p_in = edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0
            q_in = edge[0] * (q[1] - a[1]) - edge[1] * (q[0] - a[0]) >= 0
            if p_in:
                out.append(p)
            if p_in != q_in:
                dx, dy = q[0] - p[0], q[1] - p[1]
                denom = edge[0] * dy - edge[1] * dx
                if abs(denom) < 1e-12:
                    continue
                t = (edge[0] * (a[1] - p[1]) - edge[1] * (a[0] - p[0])) / denom
                out.append((p[0] + t * dx, p[1] + t * dy))
    return out


def _poly_area(poly):
    if len(poly) < 3:
        return 0.0
    a = 0.0
    for i in range(len(poly)):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % len(poly)]
        a += x1 * y2 - x2 * y1
    return abs(a) / 2.0


def boxes_bev_iou_cpu(boxes_a, boxes_b):
    """Exact rotated BEV IoU, (N, 7) x (M, 7) -> (N, M) (host reference)."""
    boxes_a = np.asarray(boxes_a, dtype=np.float64)
    boxes_b = np.asarray(boxes_b, dtype=np.float64)
    ca = corners_bev(boxes_a)
    cb = corners_bev(boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    iou = np.zeros((len(boxes_a), len(boxes_b)), dtype=np.float32)
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            inter = _poly_area(_polygon_clip(ca[i], cb[j]))
            union = area_a[i] + area_b[j] - inter
            if union > 1e-12:
                iou[i, j] = inter / union
    return iou


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned BEV IoU after snapping each box to its nearest axis-aligned
    orientation. (N, 7) x (M, 7) -> (N, M)."""
    boxes_a = np.asarray(boxes_a)
    boxes_b = np.asarray(boxes_b)

    def to_bev(boxes):
        rot = np.abs(common_utils.limit_period(boxes[:, 6], 0.5, np.pi))
        swap = rot > np.pi / 4
        dx = np.where(swap, boxes[:, 4], boxes[:, 3])
        dy = np.where(swap, boxes[:, 3], boxes[:, 4])
        return np.stack(
            [boxes[:, 0] - dx / 2, boxes[:, 1] - dy / 2,
             boxes[:, 0] + dx / 2, boxes[:, 1] + dy / 2],
            axis=-1,
        )

    a = to_bev(boxes_a)[:, None, :]
    b = to_bev(boxes_b)[None, :, :]
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.clip(area_a + area_b - inter, 1e-6, None)
