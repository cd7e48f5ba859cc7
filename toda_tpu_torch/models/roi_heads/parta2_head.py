"""PartA2FCHead — RoI-aware part and feature pooling, grid convs, FC
refinement (PartA2 stage 2).

Counterpart of ``toda_tpu/models/roi_heads/parta2_head.py`` in eval mode
(no dropout): avg-pool of [part offset, segmentation score] (part offsets
gated by SEG_MASK_SCORE_THRESH) and max-pool of the backbone's point
features into a GxGxG grid per RoI (``ops/roi_pool3d.py``, one box test per
scan for both pools), two dense 3x3x3
conv stacks with masked BatchNorm, merged and flattened in (x, y, z, c)
order, shared FCs, then the cls and reg heads. Tensors stay channels-last as
in flax; the convs see them as channels-last NCDHW views.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roi_pool3d import pool_cells, roi_cells
from ..model_utils.masked_norm import MaskedBatchNorm, add_fc_stack, fc_stack


class PartA2FCHead(nn.Module):
    def __init__(self, model_cfg, point_feature_channels, num_class=1, code_size=7):
        super().__init__()
        cfg = self.model_cfg = model_cfg
        self.g = int(cfg["ROI_AWARE_POOL"]["POOL_SIZE"])
        c0 = int(cfg["ROI_AWARE_POOL"].get("NUM_FEATURES", 128)) // 2
        for tag, cin in (("conv_part", 4), ("conv_rpn", point_feature_channels)):
            for i, ch in enumerate((64, c0)):
                self.add_module(f"{tag}{i}", nn.Conv3d(cin, ch, 3, padding=1, bias=False))
                self.add_module(f"{tag}{i}_bn", MaskedBatchNorm(ch))
                cin = ch
        c = add_fc_stack(self, "shared", 2 * c0 * self.g ** 3, cfg["SHARED_FC"])
        nc = 1 if cfg.get("CLASS_AGNOSTIC", True) else num_class
        for tag, fcs, out_ch in (("cls", cfg["CLS_FC"], nc), ("reg", cfg["REG_FC"], code_size * nc)):
            self.add_module(f"{tag}_out", nn.Linear(add_fc_stack(self, tag, c, fcs), out_ch))
        # flax kernel inits of the two output layers
        self.cls_out.flax_init = "xavier_normal"
        self.reg_out.flax_init = ("normal", 0.001)

    def conv_stack(self, x, roi_mask, tag):
        """x (B, R, G, G, G, C) channels-last -> (B, R, G, G, G, c0)."""
        b, r = roi_mask.shape
        for i in range(2):
            conv = getattr(self, f"{tag}{i}")
            y = F.conv3d(x.reshape(b * r, *x.shape[2:]).permute(0, 4, 1, 2, 3), conv.weight,
                         padding=1)
            y = y.permute(0, 2, 3, 4, 1).reshape(b, r, *y.shape[2:], -1)
            x = torch.relu(getattr(self, f"{tag}{i}_bn")(y, roi_mask[:, :, None, None, None]))
        return x

    def forward(self, batch_dict):
        rois, roi_mask = batch_dict["rois"], batch_dict["roi_mask"]
        thresh = float(self.model_cfg.get("SEG_MASK_SCORE_THRESH", 0.3))
        pts, pmask = batch_dict["point_coords"], batch_dict["point_mask"]
        seg = batch_dict["point_cls_scores"]
        part = torch.where((seg >= thresh)[..., None], batch_dict["point_part_offset"],
                           torch.zeros((), device=seg.device))
        part_feats = torch.cat([part, seg[..., None]], dim=-1)
        b, r = roi_mask.shape
        g, n_cells = self.g, r * self.g ** 3
        pooled_part, pooled_rpn = [], []
        for i in range(b):  # one box test per scan feeds both pools
            point_idx, flat = roi_cells(pts[i], pmask[i], rois[i, :, :7], g)
            pooled_part.append(pool_cells(part_feats[i], point_idx, flat, n_cells, "avg"))
            pooled_rpn.append(pool_cells(batch_dict["point_features"][i], point_idx, flat,
                                         n_cells, "max"))
        pooled_part = torch.stack(pooled_part).view(b, r, g, g, g, -1)
        pooled_rpn = torch.stack(pooled_rpn).view(b, r, g, g, g, -1)
        merged = torch.cat([self.conv_stack(pooled_rpn, roi_mask, "conv_rpn"),
                            self.conv_stack(pooled_part, roi_mask, "conv_part")], dim=-1)
        h = fc_stack(self, "shared", merged.flatten(2), roi_mask)
        batch_dict["rcnn_cls"] = self.cls_out(fc_stack(self, "cls", h, roi_mask))
        batch_dict["rcnn_reg"] = self.reg_out(fc_stack(self, "reg", h, roi_mask))
        return batch_dict
