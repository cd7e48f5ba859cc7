"""Rotated BEV IoU by Green's-theorem edge clipping, in PyTorch.

Counterpart of ``toda_tpu/ops/rotated_iou.py``: the intersection area of two
convex quads is the sum, over the sub-segments of each quad's edges inside the
other, of 1/2 * cross(u, v) for a sub-segment u -> v. Each sub-segment is a
Liang-Barsky clip against four half-planes: all elementwise, no sort, no
gather. A's edges clip inclusively and B's exclusively, so a shared boundary
counts once. Every function broadcasts over leading batch dims.
"""

import torch

_EPS = 1e-8


def _box_corners_bev(boxes):
    """(..., 7) -> (..., 4, 2) CCW corners."""
    template = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=boxes.dtype,
                            device=boxes.device) / 2.0
    dxy = boxes[..., None, 3:5] * template
    cosa = torch.cos(boxes[..., 6])[..., None]
    sina = torch.sin(boxes[..., 6])[..., None]
    x = dxy[..., 0] * cosa - dxy[..., 1] * sina + boxes[..., None, 0]
    y = dxy[..., 0] * sina + dxy[..., 1] * cosa + boxes[..., None, 1]
    return torch.stack([x, y], dim=-1)


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def _clipped_edge_contrib(px, py, rx, ry, quad_x, quad_y, bias):
    """cross(u, v) of the edge p -> p+r clipped to a convex CCW quad (0 where
    the clip is empty); bias >= 0 clips exclusively, < 0 inclusively."""
    t_lo = torch.zeros_like(px)
    t_hi = torch.ones_like(px)
    for j in range(4):
        qx, qy = quad_x[j], quad_y[j]
        sx = quad_x[(j + 1) % 4] - qx
        sy = quad_y[(j + 1) % 4] - qy
        c0 = _cross(sx, sy, px - qx, py - qy) - bias
        cr = _cross(sx, sy, rx, ry)
        par = torch.abs(cr) < _EPS
        t_bound = -c0 / torch.where(par, torch.ones_like(cr), cr)
        zero = torch.zeros_like(t_bound)
        lo = torch.where(par, torch.where(c0 < 0, torch.full_like(c0, 1e9), zero),
                         torch.where(cr > 0, t_bound, zero))
        t_lo = torch.maximum(t_lo, lo)
        t_hi = torch.minimum(t_hi, torch.where(~par & (cr < 0), t_bound,
                                               torch.ones_like(t_bound)))
    valid = t_hi > t_lo
    t_lo = torch.clamp(t_lo, max=1.0)
    ux, uy = px + t_lo * rx, py + t_lo * ry
    vx, vy = px + t_hi * rx, py + t_hi * ry
    return torch.where(valid, _cross(ux, uy, vx, vy), torch.zeros_like(ux))


def _intersection_area_grid(corners_a, corners_b):
    """corners (..., N, 4, 2), (..., M, 4, 2) -> (..., N, M) intersection areas."""
    mid_a = corners_a.mean(dim=-2)
    mid_b = corners_b.mean(dim=-2)
    # centre each pair near the origin: f32 cross products at scene
    # coordinates (|xy| ~ 50 m) would carry ~1e-5 rounding
    midx = (mid_a[..., :, None, 0] + mid_b[..., None, :, 0]) / 2
    midy = (mid_a[..., :, None, 1] + mid_b[..., None, :, 1]) / 2
    axc = [corners_a[..., :, None, k, 0] - midx for k in range(4)]
    ayc = [corners_a[..., :, None, k, 1] - midy for k in range(4)]
    bxc = [corners_b[..., None, :, k, 0] - midx for k in range(4)]
    byc = [corners_b[..., None, :, k, 1] - midy for k in range(4)]
    total = torch.zeros_like(midx)
    for i in range(4):
        px, py = axc[i], ayc[i]
        total = total + _clipped_edge_contrib(
            px, py, axc[(i + 1) % 4] - px, ayc[(i + 1) % 4] - py, bxc, byc, -1e-6)
        px, py = bxc[i], byc[i]
        total = total + _clipped_edge_contrib(
            px, py, bxc[(i + 1) % 4] - px, byc[(i + 1) % 4] - py, axc, ayc, 1e-6)
    return torch.clamp(total / 2.0, min=0.0)


def boxes_overlap_bev(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV intersection area."""
    return _intersection_area_grid(_box_corners_bev(boxes_a), _box_corners_bev(boxes_b))


def boxes_iou_bev(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)
