"""RoI-aware voxel pooling in plain PyTorch.

Counterpart of ``toda_tpu/ops/roi_pool3d.py`` (``roiaware_pool3d``, :23-60;
JAX has no Pallas kernel here). JAX maps every RoI over every point, which
at PartA2's Waymo scale (2.6M stage-1 cells and 100 RoIs a scan) would be a
(100, 2.6M, C) tensor per scan. Here a conservative box test on chunks of
RoIs finds the (RoI, point) pairs that can fall inside (``roi_cells``), only
those get JAX's exact f32 cell arithmetic, and each feature set is pooled by
one scatter of those pairs (``pool_cells``). A caller that pools several
feature sets over the same points and RoIs finds the pairs once.
"""

import torch

ROI_CHUNK = 32  # RoIs whose box test runs at once: (ROI_CHUNK, P) bool temporaries


def _candidates(points, points_mask, rois):
    """(roi, point) index pairs whose point may lie in the roi: within its
    half diagonal in x and y and its half height in z, with a margin that
    covers the rounding of the exact test. rois (R, 7) -> two (K,) int64."""
    half = 0.5 * rois[:, 3:6].clamp(min=1e-4)
    reach_xy = torch.sqrt(half[:, 0] ** 2 + half[:, 1] ** 2) * (1 + 1e-4) + 1e-3
    reach = torch.stack([reach_xy, reach_xy, half[:, 2] * (1 + 1e-4) + 1e-3], dim=1)
    lo, hi = rois[:, :3] - reach, rois[:, :3] + reach
    near = points_mask[None].expand(rois.shape[0], -1).clone()
    for d in range(3):
        near &= points[None, :, d] >= lo[:, d, None]
        near &= points[None, :, d] <= hi[:, d, None]
    return near.nonzero(as_tuple=True)


def roi_cells(points, points_mask, rois, out_size):
    """The points of one scan that fall in a cell of a roi's (G, G, G) grid.

    points (P, 3+), points_mask (P,) bool, rois (R, 7), out_size G. Returns
    (point index (K,), flat cell (K,) = roi * G^3 + (gx * G + gy) * G + gz).
    A point's cell is floor(frac * G) with frac = local / max(size, 1e-4) +
    0.5 in the roi frame, in JAX's f32 op order, so a point on a cell
    boundary lands in the same cell."""
    g = out_size
    pts, flats = [], []
    for r0 in range(0, rois.shape[0], ROI_CHUNK):
        box = rois[r0:r0 + ROI_CHUNK].float()
        r, p = _candidates(points, points_mask, box)
        bx = box[r]
        rel = points[p, :3].float() - bx[:, :3]
        cos, sin = torch.cos(-bx[:, 6]), torch.sin(-bx[:, 6])
        local = torch.stack([rel[:, 0] * cos - rel[:, 1] * sin,
                             rel[:, 0] * sin + rel[:, 1] * cos, rel[:, 2]], dim=1)
        cell = torch.floor((local / bx[:, 3:6].clamp(min=1e-4) + 0.5) * g).long()
        inside = ((cell >= 0) & (cell < g)).all(dim=1)
        flat = (r + r0) * g ** 3 + (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
        pts.append(p[inside])
        flats.append(flat[inside])
    return torch.cat(pts), torch.cat(flats)


def pool_cells(point_features, point_idx, flat, n_cells, pool):
    """(n_cells, C) float32 pools of point_features (P, C) over the
    (point, cell) pairs of ``roi_cells``: 'max' (0 where a cell is empty)
    or 'avg'."""
    feats = point_features.float()[point_idx]
    c = feats.shape[1]
    if pool == "max":
        out = torch.full((n_cells, c), float("-inf"), device=feats.device)
        out.scatter_reduce_(0, flat[:, None].expand(-1, c), feats, "amax")
        return torch.where(torch.isinf(out), torch.zeros((), device=out.device), out)
    out = torch.zeros((n_cells, c), device=feats.device).index_add_(0, flat, feats)
    cnt = torch.zeros((n_cells,), device=feats.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    return out / cnt[:, None].clamp(min=1.0)


def roiaware_pool3d(points, point_features, points_mask, rois, out_size=6, pool="max"):
    """RoI-aware voxel pooling of one scan (``roiaware_pool3d`` :23).

    Args:
        points: (P, 3+); point_features: (P, C); points_mask: (P,) bool;
        rois: (R, 7); out_size: G, the (G, G, G) grid of each roi;
        pool: 'max' (0 where a cell is empty) or 'avg'.
    Returns (R, G, G, G, C) float32.
    """
    g, n_roi = out_size, rois.shape[0]
    point_idx, flat = roi_cells(points, points_mask, rois, g)
    out = pool_cells(point_features, point_idx, flat, n_roi * g ** 3, pool)
    return out.view(n_roi, g, g, g, -1)
