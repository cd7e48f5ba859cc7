"""World-level augmentation primitives (host numpy) with record/replay params.

The port's own copy of the three ops of ``toda_tpu/datasets/augmentor/
augmentor_utils.py`` that the synthetic training config runs. Each takes an
optional ``params``: ``None`` draws fresh randomness from the global numpy
generator (as the JAX package does, so both see the same draws under the same
``np.random.seed``) and returns the params used; a value replays them.
"""

import numpy as np

from ...utils import common_utils


def random_flip_along_x(gt_boxes, points, params=None):
    """Flip y with probability 0.5. Returns (boxes, points, enable flag)."""
    enable = np.random.choice([False, True]) if params is None else bool(params)
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]  # velocity_y
    return gt_boxes, points, enable


def global_rotation(gt_boxes, points, rot_range, params=None):
    """Rotate the scene about z by U(rot_range). Returns (boxes, points, angle)."""
    noise = (
        np.random.uniform(rot_range[0], rot_range[1]) if params is None else float(params)
    )
    points = common_utils.rotate_points_along_z(points[None], np.array([noise]))[0]
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 0:3] = common_utils.rotate_points_along_z(
        gt_boxes[None, :, 0:3], np.array([noise])
    )[0]
    gt_boxes[:, 6] += noise
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate(
            [gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1), dtype=gt_boxes.dtype)], axis=1
        )
        gt_boxes[:, 7:9] = common_utils.rotate_points_along_z(vel[None], np.array([noise]))[
            0, :, 0:2
        ]
    return gt_boxes, points, noise


def global_scaling(gt_boxes, points, scale_range, params=None):
    """Scale the scene by U(scale_range). Returns (boxes, points, scale)."""
    if scale_range[1] - scale_range[0] < 1e-3 and params is None:
        return gt_boxes, points, 1.0
    scale = (
        np.random.uniform(scale_range[0], scale_range[1]) if params is None else float(params)
    )
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:9] *= scale
    return gt_boxes, points, scale
