"""Synthetic LiDAR scenes — the hermetic train and eval fixture.

The port's own copy of ``toda_tpu/datasets/synthetic/synthetic_dataset.py``
(without the camera rendering and the gt database, which only training and
the camera detectors use): boxes placed collision-free in the range, points
sampled on box surfaces + ground clutter, deterministic per (seed, index), so
both packages see identical scenes.
"""

import numpy as np

from ...utils import box_utils
from ..dataset import DatasetTemplate

DEFAULT_SIZES = {
    "car": (4.6, 1.95, 1.7),
    "pedestrian": (0.8, 0.7, 1.7),
    "cyclist": (1.8, 0.8, 1.6),
}


def make_scene(
    rng,
    class_names,
    pc_range,
    num_objects=(3, 10),
    points_per_object=(60, 400),
    num_background=2000,
    num_features=4,
    size_scale=1.0,
):
    """Returns (points (N, num_features), gt_boxes (M, 7), gt_names (M,))."""
    pc_range = np.asarray(pc_range, dtype=np.float32)
    n_obj = rng.randint(num_objects[0], num_objects[1] + 1)
    boxes, names = [], []
    tries = 0
    while len(boxes) < n_obj and tries < n_obj * 10:
        tries += 1
        cls = class_names[rng.randint(len(class_names))]
        base = DEFAULT_SIZES.get(cls, (4.0, 2.0, 1.6))
        dims = np.asarray(base) * size_scale * rng.uniform(0.85, 1.15, 3)
        margin = max(base[0], base[1])
        cx = rng.uniform(pc_range[0] + margin, pc_range[3] - margin)
        cy = rng.uniform(pc_range[1] + margin, pc_range[4] - margin)
        cz = rng.uniform(-1.2, -0.6) + dims[2] / 2
        yaw = rng.uniform(-np.pi, np.pi)
        cand = np.array([cx, cy, cz, *dims, yaw], dtype=np.float32)
        if boxes:
            iou = box_utils.boxes3d_nearest_bev_iou(cand[None, :7], np.stack(boxes)[:, :7])
            if iou.max() > 1e-3:
                continue
        boxes.append(cand)
        names.append(cls)
    gt_boxes = np.stack(boxes) if boxes else np.zeros((0, 7), np.float32)
    gt_names = np.asarray(names)

    pts = []
    for box in gt_boxes:
        n_pts = rng.randint(points_per_object[0], points_per_object[1] + 1)
        # surface-ish samples: uniform in box, pushed toward faces
        local = rng.uniform(-0.5, 0.5, (n_pts, 3))
        face = rng.randint(0, 3, n_pts)
        sign = rng.choice([-0.5, 0.5], n_pts)
        local[np.arange(n_pts), face] = sign * rng.uniform(0.9, 1.0, n_pts)
        local *= box[3:6]
        c, s = np.cos(box[6]), np.sin(box[6])
        x = local[:, 0] * c - local[:, 1] * s + box[0]
        y = local[:, 0] * s + local[:, 1] * c + box[1]
        z = local[:, 2] + box[2]
        feat = rng.uniform(0, 1, (n_pts, num_features - 3)).astype(np.float32)
        pts.append(np.concatenate([np.stack([x, y, z], 1).astype(np.float32), feat], 1))

    bg_xy = rng.uniform(pc_range[[0, 1]], pc_range[[3, 4]], (num_background, 2))
    bg_z = rng.normal(-1.6, 0.05, (num_background, 1))
    bg_feat = rng.uniform(0, 1, (num_background, num_features - 3))
    pts.append(np.concatenate([bg_xy, bg_z, bg_feat], 1).astype(np.float32))
    points = np.concatenate(pts, axis=0)
    return points, gt_boxes, gt_names


class SyntheticDataset(DatasetTemplate):
    """Deterministic synthetic scenes behind the standard DatasetTemplate API."""

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg,
            class_names=class_names,
            training=training,
            root_path=root_path,
            logger=logger,
        )
        self.num_scenes = int(dataset_cfg.get("NUM_SCENES", 64))
        # TEST_SEED_OFFSET: seed shift applied in test mode (default 10_000 =
        # a disjoint val split). Setting it to 0 makes a test-mode loader
        # present the TRAIN scenes — the synthetic analog of the reference
        # pseudo-label configs pointing DATA_SPLIT.test at the train infos,
        # needed so pseudo labels are generated for the same frames stage 2
        # reads back.
        test_offset = int(dataset_cfg.get("TEST_SEED_OFFSET", 10_000))
        self.seed = int(dataset_cfg.get("SEED", 0)) + (0 if training else test_offset)
        self.num_features = len(dataset_cfg.POINT_FEATURE_ENCODING.src_feature_list)
        self.scene_kwargs = dict(
            num_objects=tuple(dataset_cfg.get("NUM_OBJECTS", (3, 10))),
            num_background=int(dataset_cfg.get("NUM_BACKGROUND_POINTS", 2000)),
            # per-object point-count range — the synthetic analog of beam
            # density, used to fabricate a dense->sparse domain gap
            # (Waymo 64-beam -> nuScenes 32-beam) for SSDA experiments
            points_per_object=tuple(
                dataset_cfg.get("POINTS_PER_OBJECT", (60, 400))),
            # global object-size multiplier — the synthetic analog of the
            # Waymo->nuScenes size-statistics gap (US vs SG car sizes)
            size_scale=float(dataset_cfg.get("SIZE_SCALE", 1.0)),
        )

    def __len__(self):
        return self.num_scenes

    def get_raw_scene(self, index):
        rng = np.random.RandomState(self.seed + index)
        return make_scene(
            rng,
            self.class_names,
            self.point_cloud_range,
            num_features=self.num_features,
            **self.scene_kwargs,
        )

    def __getitem__(self, index):
        points, gt_boxes, gt_names = self.get_raw_scene(index)
        data_dict = {
            "points": points,
            "gt_boxes": gt_boxes,
            "gt_names": gt_names,
            "frame_id": index,
        }
        return self.prepare_data(data_dict=data_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        """Simple mAP@IoU(0.5) over synthetic GT (hermetic eval harness)."""
        from ...utils.eval_utils import eval_map

        gt_annos = []
        for i in range(len(self)):
            _, boxes, names = self.get_raw_scene(i)
            gt_annos.append({"boxes_lidar": boxes, "name": names})
        ap_dict = eval_map(det_annos, gt_annos, class_names, iou_thresh=0.5)
        ap_str = "\n".join(f"{k}: {v:.4f}" for k, v in ap_dict.items())
        return ap_str, ap_dict
