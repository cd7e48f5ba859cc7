"""Config-driven detector assembly and its training and inference surface.

Counterpart of ``toda_tpu/models/detectors/detector3d.py``: ``DatasetMeta``,
the ``Detector3D`` path for point-consuming backbones (the backbone owns its
voxelization), ``DetectorBundle.loss`` / ``head_loss`` (the CenterHead
branch, :540-567, :616-644) and ``predict`` / ``post_processing`` (:720-743).
Detector families other than CenterPoint-Res come in later slices.
"""

from dataclasses import dataclass

import torch
from torch import nn

from ...ops.nms import class_agnostic_nms
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev.height_compression import HeightCompression
from ..backbones_3d.pillar_sparse_backbone import PillarResBackBone8x
from ..dense_heads.center_head import CenterHead
from ...weights import init_like_flax_


@dataclass(frozen=True)
class DatasetMeta:
    """Static dataset facts the model needs when it is built."""

    class_names: tuple
    point_cloud_range: tuple
    voxel_size: tuple
    grid_size: tuple  # (nx, ny, nz)
    num_point_features: int

    @classmethod
    def from_dataset(cls, dataset):
        return cls(
            class_names=tuple(dataset.class_names),
            point_cloud_range=tuple(float(v) for v in dataset.point_cloud_range),
            voxel_size=tuple(float(v) for v in dataset.voxel_size),
            grid_size=tuple(int(v) for v in dataset.grid_size),
            num_point_features=dataset.point_feature_encoder.num_point_features,
        )


def _require(cfg, key, name):
    got = cfg.get(key, {}).get("NAME") if cfg.get(key) else None
    if got != name:
        raise NotImplementedError(f"{key} {got} is not ported to the PyTorch package yet "
                                  f"(ported: {name})")


class Detector3D(nn.Module):
    """PillarResBackBone8x -> HeightCompression -> BaseBEVBackbone ->
    CenterHead, each built from the model config."""

    def __init__(self, model_cfg, meta):
        super().__init__()
        _require(model_cfg, "BACKBONE_3D", "PillarResBackBone8x")
        _require(model_cfg, "MAP_TO_BEV", "HeightCompression")
        _require(model_cfg, "BACKBONE_2D", "BaseBEVBackbone")
        _require(model_cfg, "DENSE_HEAD", "CenterHead")
        self.backbone_3d = PillarResBackBone8x(
            model_cfg["BACKBONE_3D"], meta.num_point_features, meta.grid_size,
            meta.voxel_size, meta.point_cloud_range)
        self.map_to_bev = HeightCompression()
        self.backbone_2d = BaseBEVBackbone(model_cfg["BACKBONE_2D"],
                                           self.backbone_3d.num_bev_features)
        self.dense_head = CenterHead(
            model_cfg["DENSE_HEAD"], self.backbone_2d.num_bev_features, meta.class_names,
            meta.grid_size, meta.point_cloud_range, meta.voxel_size)

    def forward(self, batch_dict):
        batch_dict = dict(batch_dict)
        for stage in (self.backbone_3d, self.map_to_bev, self.backbone_2d, self.dense_head):
            batch_dict = stage(batch_dict)
        return batch_dict


class DetectorBundle:
    """The detector module on its device plus its training and inference
    surface. The module is initialised as the JAX package initialises it
    (``weights.init_like_flax_``) from ``seed``."""

    def __init__(self, model_cfg, num_class, dataset, device, seed=0):
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.device = device
        self.meta = DatasetMeta.from_dataset(dataset)
        self.module = init_like_flax_(Detector3D(model_cfg, self.meta), seed).to(device).eval()
        self.post_cfg = model_cfg.get("POST_PROCESSING", {})

    def to_device(self, batch):
        """Model inputs (and ``gt_boxes`` when the batch has them) of a batch
        of numpy arrays or tensors, as tensors on the bundle's device."""
        dtypes = {"points": torch.float32, "points_mask": torch.bool,
                  "gt_boxes": torch.float32}
        return {k: torch.as_tensor(batch[k], dtype=dt, device=self.device)
                for k, dt in dtypes.items() if k in batch}

    def head_loss(self, out, gt_boxes):
        """(total, tb) detection loss of the forward outputs (CenterHead)."""
        return self.module.dense_head.get_loss(out, gt_boxes)

    def loss(self, batch_dict):
        """Forward in training mode (batch statistics; BatchNorm running
        statistics updated) and the loss: (total, tb dict of scalar
        tensors). Differentiable in the module's parameters."""
        if not self.module.training:
            self.module.train()
        out = self.module(batch_dict)
        return self.head_loss(out, batch_dict["gt_boxes"])

    def forward(self, batch_dict):
        """Raw forward outputs (backbone features and head maps), in eval
        mode and under ``inference_mode``: nothing is saved for autograd."""
        if self.module.training:
            self.module.eval()
        with torch.inference_mode():
            return self.module(batch_dict)

    def predict(self, batch_dict):
        """Forward + decode + NMS -> dict of (B, K) final detections."""
        return self.post_processing(self.forward(batch_dict))

    def post_processing(self, out):
        """Static-K decode + class-agnostic NMS (CenterHead branch)."""
        cfg = self.post_cfg
        nms_cfg = cfg.get("NMS_CONFIG", {})
        with torch.inference_mode():
            boxes, scores, labels = self.decode(out)
            idx, mask = class_agnostic_nms(
                scores, boxes[..., :7], score_thresh=cfg.get("SCORE_THRESH", 0.1),
                nms_thresh=float(nms_cfg.get("NMS_THRESH", 0.2)),
                pre_maxsize=int(nms_cfg.get("NMS_PRE_MAXSIZE", 1024)),
                post_maxsize=int(nms_cfg.get("NMS_POST_MAXSIZE", 128)),
            )
            box_idx = idx[..., None].expand(-1, -1, boxes.shape[-1])
            return {
                "pred_boxes": torch.gather(boxes, 1, box_idx),
                "pred_scores": torch.gather(scores, 1, idx) * mask,
                "pred_labels": torch.gather(labels, 1, idx) * mask,
                "pred_mask": mask,
            }

    def decode(self, out):
        """(B, MAX_OBJ_PER_SAMPLE) top-K boxes, scores and labels, no NMS."""
        max_obj = int(self.post_cfg.get("MAX_OBJ_PER_SAMPLE", 128))
        return self.module.dense_head.generate_predicted_boxes(out, max_obj=max_obj)


def build_detector(model_cfg, num_class, dataset, device, seed=0):
    return DetectorBundle(model_cfg=model_cfg, num_class=num_class, dataset=dataset,
                          device=device, seed=seed)
