"""Config-driven augmentation queue with record/replay (host numpy).

The port's own copy of ``toda_tpu/datasets/augmentor/data_augmentor.py`` cut
to the ops the synthetic and Waymo training configs run without gt_sampling
(``random_world_flip`` along x and y, ``random_world_rotation``,
``random_world_scaling``). Each op appends
``(name, params)`` to ``data_dict['augmentation_params']``; a
``data_dict['replay_params']`` list replays a recorded sequence instead of
drawing.
"""

from functools import partial

import numpy as np

from ...utils import common_utils
from . import augmentor_utils


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_config_list = (
            augmentor_configs
            if isinstance(augmentor_configs, list)
            else augmentor_configs.AUG_CONFIG_LIST
        )
        disable_list = (
            []
            if isinstance(augmentor_configs, list)
            else augmentor_configs.get("DISABLE_AUG_LIST", [])
        )
        for cur_cfg in aug_config_list:
            if cur_cfg.NAME in disable_list:
                continue
            if not hasattr(self, cur_cfg.NAME):
                raise NotImplementedError(
                    f"augmentation {cur_cfg.NAME} is not ported to the PyTorch package yet")
            self.data_augmentor_queue.append(getattr(self, cur_cfg.NAME)(config=cur_cfg))

    def _replay_param(self, data_dict, name):
        for n, p in data_dict.get("replay_params", None) or []:
            if n == name:
                return p
        return None

    def _record(self, data_dict, name, params):
        data_dict.setdefault("augmentation_params", []).append((name, params))

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes = data_dict.get("gt_boxes", np.zeros((0, 7), np.float32))
        points = data_dict["points"]
        for cur_axis in config.ALONG_AXIS_LIST:
            name = f"random_world_flip_{cur_axis}"
            fn = getattr(augmentor_utils, f"random_flip_along_{cur_axis}")
            gt_boxes, points, used = fn(gt_boxes, points,
                                        params=self._replay_param(data_dict, name))
            self._record(data_dict, name, used)
        data_dict["gt_boxes"] = gt_boxes
        data_dict["points"] = points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config.WORLD_ROT_ANGLE
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points, used = augmentor_utils.global_rotation(
            data_dict.get("gt_boxes", np.zeros((0, 7), np.float32)),
            data_dict["points"],
            rot_range=rot_range,
            params=self._replay_param(data_dict, "random_world_rotation"),
        )
        self._record(data_dict, "random_world_rotation", used)
        data_dict["gt_boxes"] = gt_boxes
        data_dict["points"] = points
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points, used = augmentor_utils.global_scaling(
            data_dict.get("gt_boxes", np.zeros((0, 7), np.float32)),
            data_dict["points"],
            scale_range=config.WORLD_SCALE_RANGE,
            params=self._replay_param(data_dict, "random_world_scaling"),
        )
        self._record(data_dict, "random_world_scaling", used)
        data_dict["gt_boxes"] = gt_boxes
        data_dict["points"] = points
        return data_dict

    def forward(self, data_dict):
        for cur_augmentor in self.data_augmentor_queue:
            data_dict = cur_augmentor(data_dict=data_dict)
        if "gt_boxes" in data_dict and len(data_dict["gt_boxes"]):
            data_dict["gt_boxes"][:, 6] = common_utils.limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
            )
        return data_dict
