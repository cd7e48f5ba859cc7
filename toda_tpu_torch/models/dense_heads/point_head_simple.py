"""PointHeadSimple — PV-RCNN's keypoint foreground segmentation.

Counterpart of ``toda_tpu/models/dense_heads/point_head_simple.py``,
forward (:19-40): (Linear, masked BatchNorm, relu) layers over the keypoint
features (``point_features_before_fusion`` with
``USE_POINT_FEATURES_BEFORE_FUSION``), ``point_cls_preds`` and
``point_cls_scores`` (max sigmoid over classes). The point targets and the
loss (:42-90) come with PV-RCNN training.
"""

import torch
from torch import nn

from ..model_utils.masked_norm import add_fc_stack, fc_stack


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class):
        super().__init__()
        self.before_fusion = bool(model_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION", False))
        nc = 1 if model_cfg.get("CLASS_AGNOSTIC", True) else num_class
        self.cls_out = nn.Linear(add_fc_stack(self, "cls", input_channels, model_cfg["CLS_FC"]),
                                 nc)

    def forward(self, batch_dict):
        key = "point_features_before_fusion" if self.before_fusion else "point_features"
        logits = self.cls_out(fc_stack(self, "cls", batch_dict[key], batch_dict["point_mask"]))
        batch_dict["point_cls_preds"] = logits
        batch_dict["point_cls_scores"] = torch.sigmoid(logits).amax(dim=-1)
        return batch_dict
