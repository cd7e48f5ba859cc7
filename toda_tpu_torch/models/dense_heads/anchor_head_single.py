"""Single-scale anchor head (SECOND / PartA2 first stage).

Counterpart of ``toda_tpu/models/dense_heads/anchor_head_single.py``:
``AnchorHeadSingle`` (1x1 class, box and direction convs on the BEV
features; the outputs reshape to one row per anchor in the anchor
generator's order), its losses (``anchor_head_loss``: focal class loss,
smooth-L1 on the sin-difference box code, direction cross-entropy) and
``generate_predicted_boxes`` (residual decode against the anchors plus the
direction-bin heading fix).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import get_world_size
from ...utils import loss_utils
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


def add_sin_difference(boxes1, boxes2, dim=6):
    """The heading residual as sin(a - b) = sin a cos b - cos a sin b
    (:19-25): boxes1 gets sin(a) cos(b), boxes2 cos(a) sin(b)."""
    a, b = boxes1[..., dim:dim + 1], boxes2[..., dim:dim + 1]
    b1 = torch.cat([boxes1[..., :dim], torch.sin(a) * torch.cos(b), boxes1[..., dim + 1:]], -1)
    b2 = torch.cat([boxes2[..., :dim], torch.cos(a) * torch.sin(b), boxes2[..., dim + 1:]], -1)
    return b1, b2


def get_direction_target(gt_heading, dir_offset, num_bins):
    """Heading -> direction bin in [0, num_bins) (:28-33)."""
    offset_rot = limit_period_torch(gt_heading - dir_offset, 0.0, 2 * np.pi)
    dir_cls = torch.floor(offset_rot / (2 * np.pi / num_bins)).to(torch.int64)
    return torch.clamp(dir_cls, 0, num_bins - 1)


def anchor_head_loss(batch_dict, targets, model_cfg, num_class):
    """Class + box + direction losses of the anchor head (:65-111), each
    summed and divided by the batch size (the global batch's in a
    data-parallel run, whose ranks hold equal shares): (total, tb dict)."""
    lw = model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    cls_preds, box_preds = batch_dict["cls_preds"], batch_dict["box_preds"]
    batch_size = cls_preds.shape[0] * get_world_size()
    labels = targets["box_cls_labels"]
    reg_weights = targets["reg_weights"]

    positives = labels > 0
    cls_weights = (positives | (labels == 0)).to(cls_preds.dtype)
    cls_weights = cls_weights / torch.clamp(positives.sum(1, keepdim=True), min=1.0)
    one_hot = F.one_hot(torch.clamp(labels, min=0).long(), num_class + 1)[..., 1:]
    cls_loss = loss_utils.sigmoid_focal_cls_loss(cls_preds, one_hot.to(cls_preds.dtype),
                                                 cls_weights)
    cls_loss = cls_loss.sum() / batch_size * lw["cls_weight"]

    pred_sin, tg_sin = add_sin_difference(box_preds, targets["box_reg_targets"])
    loc_loss = loss_utils.weighted_smooth_l1_loss(pred_sin, tg_sin, reg_weights,
                                                  code_weights=lw.get("code_weights", None))
    loc_loss = loc_loss.sum() / batch_size * lw["loc_weight"]
    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    total = cls_loss + loc_loss

    if "dir_cls_preds" in batch_dict:
        num_bins = model_cfg.get("NUM_DIR_BINS", 2)
        dir_targets = get_direction_target(targets["matched_gt_heading"],
                                           model_cfg.get("DIR_OFFSET", 0.78539), num_bins)
        dir_preds = batch_dict["dir_cls_preds"]
        dir_loss = loss_utils.weighted_cross_entropy_loss(
            dir_preds, F.one_hot(dir_targets, num_bins).to(dir_preds.dtype), reg_weights)
        dir_loss = dir_loss.sum() / batch_size * lw["dir_weight"]
        total = total + dir_loss
        tb["rpn_loss_dir"] = dir_loss
    tb["rpn_loss"] = total
    return total, tb


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
