"""Two-view consistency loss of stage-2 TODA training.

The port's counterpart of ``toda_tpu/models/consistency.py``
(``reverse_boxes_jnp`` and ``consistency_loss`` :17-77): both views' top
boxes are mapped back to the scene's frame by reversing each view's recorded
world augmentations (the (B, 7) ``aug_vector`` [flip_x, flip_y, rot, scale,
tx, ty, tz]); each confident box of one view is matched to the nearest
confident box centre of the other, and matched pairs within a radius add a
smooth-L1 centre and an L1 size difference. Batched tensor ops on the
device, differentiable in the boxes.
"""

import math

import torch

from ..parallel.mesh import global_count


def reverse_boxes(boxes, aug_vec):
    """Undo the world augmentations on boxes (B, K, 7+) -> (B, K, 7), for
    aug_vec (B, 7). The augmentor applies flip, rotation, scaling, then
    translation; they are undone in reverse order."""
    flip_x = aug_vec[:, 0][:, None]
    flip_y = aug_vec[:, 1][:, None]
    rot = aug_vec[:, 2][:, None]
    scale = torch.clamp(aug_vec[:, 3], min=1e-3)[:, None, None]
    t = aug_vec[:, 4:7][:, None, :]

    xyz = (boxes[..., 0:3] - t) / scale
    dims = boxes[..., 3:6] / scale
    heading = boxes[..., 6] - rot
    cos, sin = torch.cos(-rot), torch.sin(-rot)
    x = xyz[..., 0] * cos - xyz[..., 1] * sin
    y = xyz[..., 0] * sin + xyz[..., 1] * cos

    y = torch.where(flip_x > 0.5, -y, y)
    heading = torch.where(flip_x > 0.5, -heading, heading)
    x = torch.where(flip_y > 0.5, -x, x)
    heading = torch.where(flip_y > 0.5, -(heading + math.pi), heading)
    return torch.cat([x[..., None], y[..., None], xyz[..., 2:3], dims, heading[..., None]],
                     dim=-1)


def consistency_loss(boxes_a, scores_a, boxes_b, scores_b, score_thresh=0.3, match_radius=2.0):
    """(centre loss, size loss) scalars between two box sets in one frame.

    boxes_* (B, K, 7), scores_* (B, K). Each box of A scoring above
    ``score_thresh`` is matched to the nearest such box centre of B (ties
    to the lower index); pairs closer than ``match_radius`` add the
    smooth-L1 (beta 1) of the centre difference and the L1 of the size
    difference, averaged over the matched pairs (at least 1; the global
    batch's pairs in a data-parallel run)."""
    va = scores_a > score_thresh
    vb = scores_b > score_thresh
    ca, cb = boxes_a[..., :3], boxes_b[..., :3]
    d2 = ((ca[:, :, None, :] - cb[:, None, :, :]) ** 2).sum(-1)  # (B, K, K)
    d2 = torch.where(vb[:, None, :], d2, torch.full_like(d2, 1e9))
    j = torch.argmin(d2, dim=-1)  # the first of equal minima, as jnp.argmin
    min_d2 = torch.gather(d2, -1, j[..., None])[..., 0]
    matched = va & (min_d2 < match_radius ** 2)

    nb = torch.gather(boxes_b, 1, j[..., None].expand(-1, -1, boxes_b.shape[-1]))
    abs_c = (ca - nb[..., :3]).abs()
    center = torch.where(abs_c < 1.0, 0.5 * abs_c ** 2, abs_c - 0.5).sum(-1)
    size = (boxes_a[..., 3:6] - nb[..., 3:6]).abs().sum(-1)

    w = matched.to(boxes_a.dtype)
    denom = torch.clamp(global_count(w.sum()), min=1.0)
    return (center * w).sum() / denom, (size * w).sum() / denom
