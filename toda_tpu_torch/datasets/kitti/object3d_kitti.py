"""KITTI label files and the official difficulty of each object.

The port's own copy of ``toda_tpu/datasets/kitti/object3d_kitti.py``. The
difficulty rule of the KITTI devkit: easy needs a 2D box at least 40 px
high, truncation <= 0.15 and occlusion 0; moderate >= 25 px, <= 0.3, <= 1;
hard >= 25 px, <= 0.5, <= 2; anything else is -1 (ignored).
"""

import numpy as np

CLS_TYPE_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}
LEVEL_NAMES = {0: "Easy", 1: "Moderate", 2: "Hard", -1: "UnKnown"}


def kitti_difficulty(bbox, truncated, occluded):
    """bbox (N, 4) [x1, y1, x2, y2] pixels, truncated (N,), occluded (N,) ->
    (N,) int32 difficulty in {0, 1, 2, -1}."""
    bbox = np.asarray(bbox, dtype=np.float32).reshape(-1, 4)
    truncated = np.asarray(truncated, dtype=np.float32).reshape(-1)
    occluded = np.asarray(occluded, dtype=np.float32).reshape(-1)
    height = bbox[:, 3] - bbox[:, 1] + 1
    easy = (height >= 40) & (truncated <= 0.15) & (occluded <= 0)
    moderate = (height >= 25) & (truncated <= 0.3) & (occluded <= 1)
    hard = (height >= 25) & (truncated <= 0.5) & (occluded <= 2)
    out = np.full(len(height), -1, dtype=np.int32)
    out[hard] = 2
    out[moderate] = 1
    out[easy] = 0
    return out


class Object3d:
    """One label line: class, truncation, occlusion, alpha, the 2D box, the
    camera box (h, w, l, location, ry) and an optional score."""

    def __init__(self, line):
        parts = line.strip().split(" ")
        self.cls_type = parts[0]
        self.cls_id = CLS_TYPE_TO_ID.get(self.cls_type, -1)
        self.truncation = float(parts[1])
        self.occlusion = float(parts[2])  # 0..3 (3 = unknown)
        self.alpha = float(parts[3])
        self.box2d = np.array([float(v) for v in parts[4:8]], dtype=np.float32)
        self.h = float(parts[8])
        self.w = float(parts[9])
        self.l = float(parts[10])  # noqa: E741
        self.loc = np.array([float(v) for v in parts[11:14]], dtype=np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.loc))
        self.ry = float(parts[14])
        self.score = float(parts[15]) if len(parts) == 16 else -1.0
        self.level = int(kitti_difficulty(self.box2d, self.truncation, self.occlusion)[0])
        self.level_str = LEVEL_NAMES[self.level]

    def get_kitti_obj_level(self):
        return self.level


def get_objects_from_label(label_file):
    with open(label_file) as f:
        return [Object3d(ln) for ln in f.readlines() if ln.strip()]
