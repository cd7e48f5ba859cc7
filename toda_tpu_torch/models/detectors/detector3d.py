"""Config-driven detector assembly and its training and inference surface.

Counterpart of ``toda_tpu/models/detectors/detector3d.py``: ``DatasetMeta``;
``Detector3D``, built from the config's module names (the backbone owns its
voxelization); the first-stage proposals of a two-stage detector
(``_make_proposals`` :295-341); ``DetectorBundle`` with the anchors and the
box coders and the anchor target assigner (:443-470, :521-525),
``loss`` / ``head_loss`` (the AnchorHeadSingle and CenterHead branches,
:540-567, :616-644), ``decode_topk`` (:646-659) and ``predict`` /
``post_processing`` (the two-stage, anchor and CenterHead branches,
:661-743). Three detectors are ported: CenterPoint(-Res)
(PillarResBackBone8x + CenterHead), SECOND (PillarBackBone8x +
AnchorHeadSingle), both with training, and PartA2 (UNetV2 + AnchorHeadSingle
+ PointHeadIntraPart + PartA2FCHead, inference).
"""

from dataclasses import dataclass

import torch
from torch import nn

from ...ops.nms import class_agnostic_nms, top_k
from ...utils.box_coder_utils import ResidualCoder
from ...weights import init_like_flax_
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev.height_compression import HeightCompression
from ..backbones_3d.pillar_sparse_backbone import PillarBackBone8x, PillarResBackBone8x
from ..backbones_3d.pillar_unet import UNetV2
from ..dense_heads.anchor_head_single import (
    AnchorHeadSingle,
    anchor_head_loss,
    generate_predicted_boxes,
)
from ..dense_heads.center_head import CenterHead
from ..dense_heads.point_head_intra_part import PointHeadIntraPart
from ..dense_heads.target_assigner.anchor_generator import AnchorGenerator
from ..dense_heads.target_assigner.axis_aligned_target_assigner import AxisAlignedTargetAssigner
from ..roi_heads.parta2_head import PartA2FCHead
from ..roi_heads.roi_utils import generate_predicted_boxes_roi, proposal_layer

BACKBONES_3D = {"PillarBackBone8x": PillarBackBone8x,
                "PillarResBackBone8x": PillarResBackBone8x, "UNetV2": UNetV2}
# the ported detectors (MODEL.NAME): (dense head, point head, roi head)
DETECTORS = {"CenterPoint": ("CenterHead", None, None),
             "SECONDNet": ("AnchorHeadSingle", None, None),
             "PartA2Net": ("AnchorHeadSingle", "PointHeadIntraPart", "PartA2FCHead")}


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


def _name(cfg, key):
    return cfg[key].get("NAME") if cfg.get(key) else None


def _require(cfg, key, names):
    got = _name(cfg, key)
    if got not in names:
        raise NotImplementedError(f"{key} {got} is not ported to the PyTorch package yet "
                                  f"(ported: {', '.join(str(n) for n in names)})")
    return got


class Detector3D(nn.Module):
    """3D backbone -> HeightCompression -> BaseBEVBackbone -> dense head
    [-> point head -> proposals -> RoI head], each built from the model
    config. ``anchors`` (numpy, the anchor head's) ride along as a
    non-persistent buffer."""

    def __init__(self, model_cfg, meta, num_class, anchors=None, num_anchors_per_location=1,
                 box_coder=None):
        super().__init__()
        self.model_cfg = model_cfg
        name = model_cfg.get("NAME")
        if name not in DETECTORS:
            raise NotImplementedError(f"detector {name} is not ported to the PyTorch package "
                                      f"yet (ported: {', '.join(DETECTORS)})")
        bb3d = _require(model_cfg, "BACKBONE_3D", BACKBONES_3D)
        _require(model_cfg, "MAP_TO_BEV", ("HeightCompression",))
        _require(model_cfg, "BACKBONE_2D", ("BaseBEVBackbone",))
        head, point_head, roi_head = DETECTORS[name]
        _require(model_cfg, "DENSE_HEAD", (head,))
        _require(model_cfg, "POINT_HEAD", (point_head,))
        _require(model_cfg, "ROI_HEAD", (roi_head,))
        self.backbone_3d = BACKBONES_3D[bb3d](
            model_cfg["BACKBONE_3D"], meta.num_point_features, meta.grid_size,
            meta.voxel_size, meta.point_cloud_range)
        self.map_to_bev = HeightCompression()
        self.backbone_2d = BaseBEVBackbone(model_cfg["BACKBONE_2D"],
                                           self.backbone_3d.num_bev_features)
        bev_ch = self.backbone_2d.num_bev_features
        self.box_coder = box_coder
        self.stages = ["backbone_3d", "map_to_bev", "backbone_2d", "dense_head"]
        if head == "CenterHead":
            self.dense_head = CenterHead(
                model_cfg["DENSE_HEAD"], bev_ch, meta.class_names, meta.grid_size,
                meta.point_cloud_range, meta.voxel_size)
        else:
            self.dense_head = AnchorHeadSingle(model_cfg["DENSE_HEAD"], bev_ch, num_class,
                                               num_anchors_per_location, box_coder.code_size)
            self.register_buffer("anchors", torch.as_tensor(anchors), persistent=False)
        if roi_head is not None:
            point_ch = self.backbone_3d.num_point_features
            self.point_head = PointHeadIntraPart(model_cfg["POINT_HEAD"], point_ch, num_class)
            self.roi_head = PartA2FCHead(model_cfg["ROI_HEAD"], point_ch, num_class,
                                         box_coder.code_size)
            self.stages += ["point_head", "proposals", "roi_head"]

    def forward(self, batch_dict):
        """The stages in order, each in a ``torch.profiler`` range named
        ``stage:<name>`` (a profile's per-stage device time)."""
        batch_dict = dict(batch_dict)
        for name in self.stages:
            with torch.profiler.record_function(f"stage:{name}"):
                batch_dict = getattr(self, name)(batch_dict)
        return batch_dict

    def proposals(self, batch_dict):
        """The anchor head's decoded boxes through the proposal NMS of the
        RoI head's NMS_CONFIG (TEST in eval, TRAIN in training) -> rois,
        roi_scores, roi_labels, roi_mask."""
        cls_logits, box_preds = generate_predicted_boxes(
            batch_dict, self.anchors, self.model_cfg["DENSE_HEAD"], self.box_coder)
        nms_cfg = self.model_cfg["ROI_HEAD"]["NMS_CONFIG"]
        nms_cfg = nms_cfg.get("TRAIN" if self.training else "TEST", nms_cfg)
        rois, scores, labels, mask = proposal_layer(box_preds, cls_logits, nms_cfg)
        batch_dict.update(rois=rois[..., :7], roi_scores=scores, roi_labels=labels,
                          roi_mask=mask)
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
        self.dense_head_name = _name(model_cfg, "DENSE_HEAD")
        self.box_coder, anchors, num_anchors_per_loc = None, None, 1
        if self.dense_head_name == "AnchorHeadSingle":
            gen = AnchorGenerator(model_cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"],
                                  self.meta.point_cloud_range, self.meta.grid_size)
            anchors, *matching, num_anchors_per_loc = gen.generate()
            self.box_coder = ResidualCoder()
        roi_cfg = model_cfg.get("ROI_HEAD") or {}
        self.roi_box_coder = ResidualCoder() if roi_cfg.get("TARGET_CONFIG") else None
        module = Detector3D(model_cfg, self.meta, num_class, anchors, num_anchors_per_loc,
                            self.box_coder)
        self.module = init_like_flax_(module, seed).to(device).eval()
        self.anchors = getattr(self.module, "anchors", None)
        self.assigner = None
        if self.anchors is not None:
            self.assigner = AxisAlignedTargetAssigner(
                self.anchors, *(torch.as_tensor(v, device=device) for v in matching),
                self.box_coder)
        self.post_cfg = model_cfg.get("POST_PROCESSING", {})

    def to_device(self, batch):
        """Model inputs (and ``gt_boxes`` when the batch has them) of a batch
        of numpy arrays or tensors, as tensors on the bundle's device."""
        dtypes = {"points": torch.float32, "points_mask": torch.bool,
                  "gt_boxes": torch.float32, "aug_vector": torch.float32}
        return {k: torch.as_tensor(batch[k], dtype=dt, device=self.device)
                for k, dt in dtypes.items() if k in batch}

    def head_loss(self, out, gt_boxes):
        """(total, tb) detection loss of the forward outputs: the
        CenterHead's, or the anchor head's on the assigner's targets
        (single-stage detectors)."""
        if hasattr(self.module, "roi_head"):
            raise NotImplementedError("training of the two-stage detectors is not ported yet")
        if self.dense_head_name == "CenterHead":
            return self.module.dense_head.get_loss(out, gt_boxes)
        return anchor_head_loss(out, self.assigner.assign(gt_boxes),
                                self.model_cfg["DENSE_HEAD"], self.num_class)

    def loss(self, batch_dict, training=True):
        """Forward and the loss: (total, tb dict of scalar tensors),
        differentiable in the module's parameters and in the points. In
        training mode BatchNorm normalises by the batch statistics and
        updates its running statistics; with ``training=False`` (the
        pseudo-label perturbation, JAX's ``loss(..., training=False,
        mutable=())``) it runs in eval mode on the running statistics and
        updates nothing."""
        self.module.train(training)
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
        """Static-K decode + class-agnostic NMS; with a RoI head the
        first-stage proposals ride along as ``rois`` / ``roi_mask``."""
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
            dets = {
                "pred_boxes": torch.gather(boxes, 1, box_idx),
                "pred_scores": torch.gather(scores, 1, idx) * mask,
                "pred_labels": torch.gather(labels, 1, idx) * mask,
                "pred_mask": mask,
            }
            if "rois" in out:
                dets["rois"], dets["roi_mask"] = out["rois"], out["roi_mask"]
            return dets

    def decode(self, out):
        """Boxes, scores and labels before the final NMS: the RoI head's
        refined boxes scored by its cls branch (two-stage), every anchor's
        decoded box with its best class (anchor head), or the CenterHead's
        (B, MAX_OBJ_PER_SAMPLE) top-K."""
        if self.roi_box_coder is not None and "rcnn_reg" in out:
            rcnn_cls, boxes = generate_predicted_boxes_roi(
                out["rois"], out["rcnn_cls"], out["rcnn_reg"], self.roi_box_coder)
            return boxes, torch.sigmoid(rcnn_cls[..., 0]) * out["roi_mask"], out["roi_labels"]
        if self.dense_head_name == "AnchorHeadSingle":
            return self._anchor_decode(out)
        max_obj = int(self.post_cfg.get("MAX_OBJ_PER_SAMPLE", 128))
        return self.module.dense_head.generate_predicted_boxes(out, max_obj=max_obj)

    def _anchor_decode(self, out):
        """Every anchor's decoded box, its best class score and label."""
        cls_logits, boxes = generate_predicted_boxes(
            out, self.anchors, self.model_cfg["DENSE_HEAD"], self.box_coder)
        scores, labels = torch.sigmoid(cls_logits).max(dim=-1)
        return boxes, scores, labels + 1

    def decode_topk(self, out, k=32):
        """(B, k) best decoded boxes (7 values) and their sigmoid scores, no
        NMS (:646-659): TODA's stage-2 consistency matching reads them, and
        its loss is differentiated through them into the head. An anchor
        head ranks every anchor (the first stage, also of a two-stage
        detector); the CenterHead its top-K."""
        if self.dense_head_name == "AnchorHeadSingle":
            boxes, scores, _ = self._anchor_decode(out)
        else:
            boxes, scores, _ = self.decode(out)
        top, idx = top_k(scores, min(k, scores.shape[-1]))
        boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
        return boxes[..., :7], top


def build_detector(model_cfg, num_class, dataset, device, seed=0):
    return DetectorBundle(model_cfg=model_cfg, num_class=num_class, dataset=dataset,
                          device=device, seed=seed)
