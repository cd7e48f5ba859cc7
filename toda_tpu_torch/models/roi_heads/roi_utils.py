"""Two-stage RoI machinery: the proposal layer and the RoI box decode.

Counterpart of ``toda_tpu/models/roi_heads/roi_utils.py``
(``proposal_layer`` :28-52, ``generate_predicted_boxes_roi`` :245-263). RoI
target sampling and the RCNN losses come with the two-stage training slice.
"""

import torch

from ...ops.nms import class_agnostic_nms
from ...utils.common_utils import rotate_points_along_z_torch


def proposal_layer(batch_box_preds, batch_cls_preds, nms_cfg):
    """Decoded first-stage boxes -> NMS-selected proposals (static post_max).

    batch_box_preds (B, N, 7+), batch_cls_preds (B, N, nc) logits. Returns rois (B, R, 7+), roi_scores
    (B, R), roi_labels (B, R) (1-indexed, 0 in empty slots) and roi_mask
    (B, R)."""
    pre_max = int(nms_cfg.get("NMS_PRE_MAXSIZE", 1024))
    post_max = int(nms_cfg.get("NMS_POST_MAXSIZE", 128))
    thresh = float(nms_cfg.get("NMS_THRESH", 0.7))
    scores, labels = torch.sigmoid(batch_cls_preds).max(dim=-1)
    idx, mask = class_agnostic_nms(scores, batch_box_preds[..., :7], score_thresh=None,
                                   nms_thresh=thresh,
                                   pre_maxsize=min(pre_max, batch_box_preds.shape[1]),
                                   post_maxsize=post_max)
    rois = torch.gather(batch_box_preds, 1,
                        idx[..., None].expand(-1, -1, batch_box_preds.shape[-1]))
    return (rois, torch.gather(scores, 1, idx) * mask,
            (torch.gather(labels, 1, idx) + 1) * mask, mask)


def generate_predicted_boxes_roi(rois, rcnn_cls, rcnn_reg, box_coder):
    """RoI-relative regression -> world boxes (rois (B, R, 7+), rcnn_cls
    (B, R, nc), rcnn_reg (B, R, code_size)): decode against the RoI moved
    to the origin, rotate by its heading, move back. Returns (rcnn_cls,
    boxes (B, R, 7))."""
    rois7 = rois[..., :box_coder.code_size]
    local_rois = torch.cat([torch.zeros_like(rois7[..., :3]), rois7[..., 3:]], dim=-1)
    local = box_coder.decode(rcnn_reg, local_rois)
    xyz = rotate_points_along_z_torch(local[..., None, 0:3].reshape(-1, 1, 3),
                                      rois7[..., 6].reshape(-1)).reshape(rois7.shape[:-1] + (3,))
    boxes = torch.cat([xyz + rois7[..., 0:3], local[..., 3:6], local[..., 6:7]], dim=-1)
    return rcnn_cls, boxes
