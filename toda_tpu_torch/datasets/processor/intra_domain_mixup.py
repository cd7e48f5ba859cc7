"""Intra-domain point-level scene MixUp (TODA stage 2), host numpy.

The port's own copy of ``toda_tpu/datasets/processor/intra_domain_mixup.py``
(``intra_domain_point_mixup`` :24 and its collision-detecting ``_cd`` variant
:35): lambda ~ Beta(alpha, alpha); keep a lambda-fraction of scene A's points
and a (1 - lambda)-fraction of scene B's, and take both scenes' boxes. The
``_cd`` variant first drops B's boxes that overlap one of A's in BEV, with
their points. The draws come in the same order as in JAX.
"""

import numpy as np

from ...utils import box_utils


def _subsample(points, frac, rng):
    """Shuffle, then keep the first int(n * frac) points."""
    n = len(points)
    idx = rng.permutation(n)
    return points[idx[: int(n * frac)]]


def _members_with_margin(points, boxes, margin=1e-1):
    """(P, 3+) x (M, 7) -> (M, P) membership with a 0.1 m x/y margin (z has
    none), as the augmentor's ``get_points_in_box``."""
    points = np.asarray(points)[:, :3]
    boxes = np.asarray(boxes)
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(boxes), len(points)), dtype=bool)
    shifted = points[None, :, :] - boxes[:, None, 0:3]
    cosa = np.cos(-boxes[:, 6])[:, None]
    sina = np.sin(-boxes[:, 6])[:, None]
    local_x = shifted[..., 0] * cosa - shifted[..., 1] * sina
    local_y = shifted[..., 0] * sina + shifted[..., 1] * cosa
    return (
        (np.abs(local_x) <= boxes[:, None, 3] / 2.0 + margin)
        & (np.abs(local_y) <= boxes[:, None, 4] / 2.0 + margin)
        & (np.abs(shifted[..., 2]) <= boxes[:, None, 5] / 2.0)
    )


def intra_domain_point_mixup(a, b, alpha=1.0, rng=None):
    """Plain MixUp: no collision handling."""
    rng = rng or np.random
    lam = rng.beta(alpha, alpha)
    points = np.concatenate([_subsample(a["points"], lam, rng),
                             _subsample(b["points"], 1.0 - lam, rng)])
    boxes = np.concatenate([a["gt_boxes"], b["gt_boxes"]])
    names = np.concatenate([a["gt_names"], b["gt_names"]])
    return {"points": points, "gt_boxes": boxes, "gt_names": names, "mixup_lambda": lam}


def intra_domain_point_mixup_cd(a, b, alpha=1.0, rng=None):
    """MixUp with collision detection: B's boxes with a nonzero rotated-BEV
    overlap with any of A's are dropped with the points inside them (with
    the 0.1 m margin) before mixing. Lambda is drawn first."""
    rng = rng or np.random
    lam = rng.beta(alpha, alpha)
    ab, bb = a["gt_boxes"], b["gt_boxes"]
    if len(ab) and len(bb):
        keep = box_utils.boxes_bev_iou_cpu(ab[:, :7], bb[:, :7]).max(axis=0) == 0
    else:
        keep = np.ones(len(bb), bool)
    b_points = b["points"]
    if (~keep).any():
        b_points = b_points[~_members_with_margin(b_points, bb[~keep][:, :7]).any(axis=0)]
    points = np.concatenate([_subsample(a["points"], lam, rng),
                             _subsample(b_points, 1.0 - lam, rng)])
    boxes = np.concatenate([ab, bb[keep]])
    names = np.concatenate([a["gt_names"], b["gt_names"][keep]])
    return {"points": points, "gt_boxes": boxes, "gt_names": names, "mixup_lambda": lam}
