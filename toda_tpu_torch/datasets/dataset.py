"""Dataset template: host pipeline ending in static-shape padded arrays.

The port's own copy of ``toda_tpu/datasets/dataset.py`` (``prepare_data``,
``pad_to_static``, ``collate_batch``,
``generate_prediction_dicts``): (training: augment) -> class filter -> point
encoding -> processors -> (training: resample a frame left without boxes) ->
pad to static caps (points -> NUM_POINTS, gt_boxes -> MAX_GT_BOXES) with
validity masks -> dense (B, ...) batches.
"""

import numpy as np

from ..utils import common_utils
from .augmentor.data_augmentor import DataAugmentor
from .point_feature_encoder import PointFeatureEncoder
from .processor.data_processor import DataProcessor


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=False, root_path=None,
                 logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = root_path if root_path is not None else dataset_cfg.get("DATA_PATH", None)
        self.point_cloud_range = np.array(dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg.POINT_FEATURE_ENCODING, point_cloud_range=self.point_cloud_range
        )
        self.data_augmentor = (
            DataAugmentor(self.root_path, dataset_cfg.DATA_AUGMENTOR, self.class_names,
                          logger=logger)
            if self.training and dataset_cfg.get("DATA_AUGMENTOR", None)
            else None
        )
        self.data_processor = DataProcessor(
            dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_points = self.data_processor.max_points or int(
            dataset_cfg.get("MAX_POINTS", 65536)
        )
        self.max_gt_boxes = int(dataset_cfg.get("MAX_GT_BOXES", 128))

    @property
    def mode(self):
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """(augment) -> class filter -> encode -> process -> pad to static shapes."""
        if self.training and self.data_augmentor is not None:
            if "gt_boxes" not in data_dict:
                raise KeyError("training needs gt_boxes")
            data_dict = self.data_augmentor.forward(data_dict)

        if data_dict.get("gt_boxes", None) is not None:
            selected = common_utils.keep_arrays_by_name(data_dict["gt_names"], self.class_names)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.float32,
            )
            data_dict["gt_boxes"] = np.concatenate(
                (data_dict["gt_boxes"].astype(np.float32), gt_classes.reshape(-1, 1)), axis=1
            )

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict=data_dict)

        if self.training and len(data_dict.get("gt_boxes", [])) == 0:
            # a frame left without boxes: draw another one (bounded, so a
            # class list that matches nothing fails instead of recursing)
            self._empty_resamples = getattr(self, "_empty_resamples", 0) + 1
            if self._empty_resamples > 128:
                raise RuntimeError(
                    f"{self._empty_resamples} consecutive empty-gt resamples: no training "
                    f"sample yields gt boxes for class_names={self.class_names}")
            return self.__getitem__(np.random.randint(len(self)))
        self._empty_resamples = 0
        return self.pad_to_static(data_dict)

    def pad_to_static(self, data_dict):
        points = np.asarray(data_dict["points"], dtype=np.float32)
        n = len(points)
        data_dict["points"] = common_utils.pad_to(points, self.max_points)
        mask = np.zeros(self.max_points, dtype=np.bool_)
        mask[: min(n, self.max_points)] = True
        data_dict["points_mask"] = mask
        if data_dict.get("gt_boxes", None) is not None:
            data_dict["gt_boxes"] = common_utils.pad_to(
                np.asarray(data_dict["gt_boxes"], dtype=np.float32), self.max_gt_boxes
            )
        data_dict.pop("gt_names", None)
        data_dict.pop("use_lead_xyz", None)
        data_dict.pop("replay_params", None)
        return data_dict

    @staticmethod
    def collate_batch(batch_list, _unused=False):
        """Stack same-shape frames into dense (B, ...) arrays; non-array metadata
        becomes lists."""
        batch = {}
        for key in batch_list[0].keys():
            vals = [d[key] for d in batch_list]
            batch[key] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) else vals
        batch["batch_size"] = len(batch_list)
        return batch

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names):
        """Decode network output into per-frame annotation dicts (numpy).

        Args:
            pred_dicts: list of {'pred_boxes' (K, 7), 'pred_scores' (K,),
                'pred_labels' (K,), 'pred_mask' (K,)} numpy per frame.
        """
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            m = box_dict.get("pred_mask", np.ones(len(box_dict["pred_scores"]), bool))
            boxes = np.asarray(box_dict["pred_boxes"])[m]
            scores = np.asarray(box_dict["pred_scores"])[m]
            labels = np.asarray(box_dict["pred_labels"])[m].astype(int)
            annos.append(
                {
                    "name": np.array([class_names[i - 1] for i in labels]),
                    "score": scores,
                    "boxes_lidar": boxes,
                    "pred_labels": labels,
                    "frame_id": batch_dict["frame_id"][index]
                    if "frame_id" in batch_dict
                    else index,
                }
            )
        return annos
