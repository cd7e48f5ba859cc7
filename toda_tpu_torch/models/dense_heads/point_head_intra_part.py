"""PointHeadIntraPart — per-cell foreground segmentation and intra-object
part offsets (PartA2 stage 1).

Counterpart of ``toda_tpu/models/dense_heads/point_head_intra_part.py``,
forward: two branches of (Linear, masked BatchNorm, relu) layers over the
backbone's point features, ``point_cls_scores`` (max sigmoid over classes)
and ``point_part_offset`` (sigmoid of the part branch). The anchor-free
``REG_FC`` box branch (PartA2_free), the targets and the losses come later.
"""

import torch
from torch import nn

from ..model_utils.masked_norm import add_fc_stack, fc_stack


class PointHeadIntraPart(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class):
        super().__init__()
        if model_cfg.get("REG_FC"):
            raise NotImplementedError("PointHeadIntraPart: the REG_FC box branch")
        nc = 1 if model_cfg.get("CLASS_AGNOSTIC", True) else num_class
        for tag, fcs, out_ch in (("cls", model_cfg["CLS_FC"], nc),
                                 ("part", model_cfg["PART_FC"], 3)):
            c = add_fc_stack(self, tag, input_channels, fcs)
            self.add_module(f"{tag}_out", nn.Linear(c, out_ch))

    def branch(self, x, mask, tag):
        return getattr(self, f"{tag}_out")(fc_stack(self, tag, x, mask))

    def forward(self, batch_dict):
        feats, mask = batch_dict["point_features"], batch_dict["point_mask"]
        logits = self.branch(feats, mask, "cls")
        part = self.branch(feats, mask, "part")
        batch_dict["point_cls_preds"] = logits
        batch_dict["point_part_preds"] = part
        batch_dict["point_cls_scores"] = torch.sigmoid(logits).amax(dim=-1)
        batch_dict["point_part_offset"] = torch.sigmoid(part)
        return batch_dict
