"""Two-view (adv, org) dataset for stage-2 consistency training.

The port's own copy of ``toda_tpu/datasets/dataset_cl.py`` (``CLPairDataset``
:13): each item is a pair of views of one sampled scene. The adv view is
augmented afresh; the org view replays the adv view's recorded augmentation
with one extra rotation and scaling on top, so the consistency loss can map
both back to the scene's frame (``aug_vector``). The collate gives a dual
batch {"adv": ..., "org": ..., "batch_size": B}.
"""

import numpy as np

from .dataset import DatasetTemplate


class CLPairDataset:
    """Wraps a dataset whose items go through ``prepare_data`` and that
    exposes its raw scenes (``get_raw_item``, as ``MixUpDataset``, or
    ``get_raw_scene``)."""

    def __init__(self, base_dataset, extra_rotation=(-0.39, 0.39), extra_scale=(0.95, 1.05)):
        self.base = base_dataset
        self.extra_rotation = extra_rotation
        self.extra_scale = extra_scale
        self.class_names = base_dataset.class_names
        self.grid_size = base_dataset.grid_size
        self.voxel_size = base_dataset.voxel_size
        self.point_cloud_range = base_dataset.point_cloud_range
        self.point_feature_encoder = base_dataset.point_feature_encoder
        self.data_processor = base_dataset.data_processor
        self.training = base_dataset.training
        self.train_percent = 0.0

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index):
        self.base.train_percent = self.train_percent
        if hasattr(self.base, "get_raw_item"):
            raw = dict(self.base.get_raw_item(index))
        else:
            points, gt_boxes, gt_names = self.base.get_raw_scene(index)
            raw = {"points": points, "gt_boxes": gt_boxes, "gt_names": gt_names}
        adv = self.base.prepare_data({**raw, "frame_id": index})
        replay = list(adv.get("augmentation_params", []))
        # the org view: the adv view's parameters with one extra independent
        # rotation and scaling composed in, recorded so it can be reversed
        extra = [
            ("random_world_rotation", float(np.random.uniform(*self.extra_rotation))),
            ("random_world_scaling", float(np.random.uniform(*self.extra_scale))),
        ]
        merged, seen = [], set()
        for name, p in replay:
            if name == "random_world_rotation":
                p = p + extra[0][1]
            elif name == "random_world_scaling":
                p = p * extra[1][1]
            merged.append((name, p))
            seen.add(name)
        merged += [(name, p) for name, p in extra if name not in seen]
        org = self.base.prepare_data({
            "points": raw["points"], "gt_boxes": raw["gt_boxes"], "gt_names": raw["gt_names"],
            "frame_id": index, "replay_params": merged})
        return {"adv": adv, "org": org}

    @staticmethod
    def collate_batch(batch_list, _unused=False):
        return {"adv": DatasetTemplate.collate_batch([b["adv"] for b in batch_list]),
                "org": DatasetTemplate.collate_batch([b["org"] for b in batch_list]),
                "batch_size": len(batch_list)}

    def evaluation(self, det_annos, class_names, **kwargs):
        return self.base.evaluation(det_annos, class_names, **kwargs)
