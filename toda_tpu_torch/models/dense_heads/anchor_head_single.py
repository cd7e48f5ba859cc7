"""Single-scale anchor head (SECOND / PartA2 first stage).

Counterpart of ``toda_tpu/models/dense_heads/anchor_head_single.py``:
``AnchorHeadSingle`` (1x1 class, box and direction convs on the BEV
features; the outputs reshape to one row per anchor in the anchor
generator's order) and ``generate_predicted_boxes`` (residual decode
against the anchors plus the direction-bin heading fix). Targets and losses
come with the anchor-head training slice.
"""

import numpy as np
import torch
from torch import nn

from ...utils.common_utils import limit_period_torch

PRIOR_PROB = 0.01


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, num_anchors_per_location,
                 code_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class, self.code_size = num_class, code_size
        a = num_anchors_per_location
        self.conv_cls = nn.Conv2d(input_channels, a * num_class, 1)
        # flax's bias_init of conv_cls: the focal-loss prior
        self.conv_cls.flax_bias_init = -float(np.log((1 - PRIOR_PROB) / PRIOR_PROB))
        self.conv_box = nn.Conv2d(input_channels, a * code_size, 1)
        self.num_dir_bins = model_cfg.get("NUM_DIR_BINS", 2)
        if model_cfg.get("USE_DIRECTION_CLASSIFIER", False):
            self.conv_dir_cls = nn.Conv2d(input_channels, a * self.num_dir_bins, 1)
        else:
            self.conv_dir_cls = None

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]  # (B, C, H, W)
        b = x.shape[0]

        def per_anchor(conv, n):
            return conv(x).permute(0, 2, 3, 1).reshape(b, -1, n)

        batch_dict["cls_preds"] = per_anchor(self.conv_cls, self.num_class)
        batch_dict["box_preds"] = per_anchor(self.conv_box, self.code_size)
        if self.conv_dir_cls is not None:
            batch_dict["dir_cls_preds"] = per_anchor(self.conv_dir_cls, self.num_dir_bins)
        return batch_dict


def generate_predicted_boxes(batch_dict, anchors, model_cfg, box_coder):
    """Per-anchor predictions -> (cls logits (B, N, nc), boxes (B, N, 7))
    (:110-131): the residual decode, then with a direction classifier the
    heading folded into the predicted direction bin."""
    boxes = box_coder.decode(batch_dict["box_preds"], anchors[None])
    if "dir_cls_preds" in batch_dict:
        num_bins = model_cfg.get("NUM_DIR_BINS", 2)
        dir_offset = model_cfg.get("DIR_OFFSET", 0.78539)
        dir_limit_offset = model_cfg.get("DIR_LIMIT_OFFSET", 0.0)
        dir_labels = batch_dict["dir_cls_preds"].argmax(dim=-1)
        period = 2 * np.pi / num_bins
        dir_rot = limit_period_torch(boxes[..., 6] - dir_offset, dir_limit_offset, period)
        heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]], dim=-1)
    return batch_dict["cls_preds"], boxes
