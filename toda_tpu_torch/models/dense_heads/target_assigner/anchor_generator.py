"""Static anchor grid (numpy, built once with the detector).

The port's own copy of
``toda_tpu/models/dense_heads/target_assigner/anchor_generator.py``. Anchors
are (H, W, A, 7) flattened to (H*W*A, 7), A iterating [class][size][bottom
height][rotation], the order the anchor head's conv outputs reshape to; each
anchor carries its class and its matching thresholds for the target
assigner.
"""

import numpy as np


class AnchorGenerator:
    def __init__(self, anchor_generator_cfg, point_cloud_range, grid_size):
        """grid_size: the voxel grid (nx, ny); anchors sit on the feature
        map grid nx/stride x ny/stride."""
        self.cfg_list = anchor_generator_cfg
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.grid_size = grid_size

    def generate(self):
        """Returns anchors (H*W*A, 7) float32, per anchor its 1-based class
        id (int32) and matched and unmatched IoU thresholds (float32), all
        in the anchors' order, and A, the anchors per location."""
        stride = int(self.cfg_list[0].get("feature_map_stride", 1))
        nx = int(self.grid_size[0]) // stride
        ny = int(self.grid_size[1]) // stride
        x0, y0, _, x1, y1, _ = self.point_cloud_range
        xs = np.linspace(x0, x1, nx, endpoint=False) + (x1 - x0) / nx / 2
        ys = np.linspace(y0, y1, ny, endpoint=False) + (y1 - y0) / ny / 2

        per_loc, cls_ids, m_thr, u_thr = [], [], [], []
        for ci, cfg in enumerate(self.cfg_list):
            assert int(cfg.get("feature_map_stride", 1)) == stride, (
                "all classes must share one feature_map_stride in this layout")
            for size in cfg["anchor_sizes"]:
                for bh in cfg.get("anchor_bottom_heights", [0.0]):
                    zc = bh + size[2] / 2.0
                    for rot in cfg["anchor_rotations"]:
                        per_loc.append((size[0], size[1], size[2], zc, rot))
                        cls_ids.append(ci + 1)
                        m_thr.append(cfg.get("matched_threshold", 0.6))
                        u_thr.append(cfg.get("unmatched_threshold", 0.45))
        a = len(per_loc)
        per_loc = np.asarray(per_loc, dtype=np.float32)  # (A, 5): dx dy dz zc rot

        gx, gy = np.meshgrid(xs, ys)  # (H=ny, W=nx)
        anchors = np.zeros((ny, nx, a, 7), dtype=np.float32)
        anchors[..., 0] = gx[:, :, None]
        anchors[..., 1] = gy[:, :, None]
        anchors[..., 2] = per_loc[None, None, :, 3]
        anchors[..., 3] = per_loc[None, None, :, 0]
        anchors[..., 4] = per_loc[None, None, :, 1]
        anchors[..., 5] = per_loc[None, None, :, 2]
        anchors[..., 6] = per_loc[None, None, :, 4]

        cells = ny * nx
        return (anchors.reshape(-1, 7), np.tile(np.asarray(cls_ids, dtype=np.int32), cells),
                np.tile(np.asarray(m_thr, dtype=np.float32), cells),
                np.tile(np.asarray(u_thr, dtype=np.float32), cells), a)
