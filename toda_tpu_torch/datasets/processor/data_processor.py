"""Host-side data processing pipeline (numpy) + voxelization *configuration*.

The port's own copy of ``toda_tpu/datasets/processor/data_processor.py``, cut
to the processors the synthetic pipeline runs, in test and train mode.
`transform_points_to_voxels` only *records* the voxelization config (grid
size, caps); the pillar voxelizer runs on the device inside the model
(``toda_tpu_torch/ops/pillar_sparse.py``). The host pipeline ends at padded
point tensors.
"""

from functools import partial

import numpy as np

from ...utils import box_utils, common_utils


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training, num_point_features=4):
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = self.voxel_size = None
        self.max_points = None  # static P cap for padded point tensors
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            cur_processor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_processor_queue.append(cur_processor)

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        if data_dict.get("points", None) is not None:
            mask = common_utils.mask_points_by_range(data_dict["points"], self.point_cloud_range)
            data_dict["points"] = data_dict["points"][mask]
        if data_dict.get("gt_boxes", None) is not None and config.REMOVE_OUTSIDE_BOXES \
                and self.training:
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict["gt_boxes"], self.point_cloud_range,
                min_num_corners=config.get("min_num_corners", 1))
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            points = data_dict["points"]
            shuffle_idx = np.random.permutation(points.shape[0])
            data_dict["points"] = points[shuffle_idx]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        """Record voxelization config; derive grid size. Device does the work."""
        if data_dict is None:
            grid_size = (
                self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
            ) / np.asarray(config.VOXEL_SIZE)
            self.grid_size = np.round(grid_size).astype(np.int64)
            self.voxel_size = np.asarray(config.VOXEL_SIZE, dtype=np.float32)
            return partial(self.transform_points_to_voxels, config=config)
        return data_dict  # no-op on host

    def sample_points(self, data_dict=None, config=None):
        """Subsample (or duplicate-pad) points to NUM_POINTS — this sets the static P.

        Reference: data_processor.sample_points (:145-175); here it doubles as the
        static-shape guarantee: after this step every frame has exactly NUM_POINTS.
        """
        if data_dict is None:
            self.max_points = int(config.NUM_POINTS[self.mode])
            return partial(self.sample_points, config=config)
        num_points = int(config.NUM_POINTS[self.mode])
        points = data_dict["points"]
        if num_points < len(points):
            # prefer keeping near points (matches reference far/near split intent)
            choice = np.random.choice(len(points), num_points, replace=False)
            points = points[choice]
        data_dict["points"] = points
        return data_dict

    def forward(self, data_dict):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict)
        return data_dict
