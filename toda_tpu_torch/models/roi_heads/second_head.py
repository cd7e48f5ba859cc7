"""SECONDHead — the SECOND-IoU RoI head: a rotated BEV crop of each RoI and
an IoU-quality regression that rescoring mixes into the final scores.

Counterpart of ``toda_tpu/models/roi_heads/second_head.py`` (:20-136). A
G x G grid of box-frame sample points per RoI is turned into BEV pixel
coordinates (pixel i's centre at i: ``(w - pc_min) / (voxel * stride) -
0.5``) and sampled bilinearly, a neighbour outside the map counting zero.
The pooled grid is flattened in JAX's order, (gy, gx, C), so a carried
``shared_fc_0`` kernel multiplies the same features; then the shared FCs
(with biases) and ``iou_head`` give sigmoid(IoU). Both the RoIs and the BEV
map are detached, as in JAX: the IoU loss trains only this head's FCs.
"""

import torch
from torch import nn

from ...ops.rotated_iou import boxes_iou3d
from ...parallel.mesh import get_world_size
from ...utils.loss_utils import smooth_l1_loss


def bilinear_sample(fmap, xy):
    """fmap (B, H, W, C) channels-last; xy (B, ..., 2) continuous pixel
    coordinates -> (B, ..., C) f32. A neighbour outside the map is zero."""
    b, h, w, c = fmap.shape
    flat = fmap.reshape(b, h * w, c)
    x, y = xy[..., 0], xy[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    batch = torch.arange(b, device=fmap.device).view(b, *([1] * (x.dim() - 1)))

    def at(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[batch, yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)].float()
        return torch.where(valid[..., None], v, torch.zeros((), device=v.device))

    out = at(y0, x0) * (1 - dx) * (1 - dy)
    out = out + at(y0, x0 + 1) * dx * (1 - dy)
    out = out + at(y0 + 1, x0) * (1 - dx) * dy
    return out + at(y0 + 1, x0 + 1) * dx * dy


def rotated_roi_grid(rois, grid_size, pc_range, bev_stride, voxel_size):
    """rois (..., N, 7) -> (..., N, G, G, 2) continuous BEV pixel coordinates
    of each RoI's G x G grid (cell centres over [-0.5, 0.5) of its length
    and width, turned by its heading)."""
    g = grid_size
    lin = (torch.arange(g, dtype=torch.float32, device=rois.device) + 0.5) / g - 0.5
    gx, gy = torch.meshgrid(lin, lin, indexing="xy")  # (G, G)
    px = gx * rois[..., None, None, 3]
    py = gy * rois[..., None, None, 4]
    cos = torch.cos(rois[..., 6])[..., None, None]
    sin = torch.sin(rois[..., 6])[..., None, None]
    wx = px * cos - py * sin + rois[..., None, None, 0]
    wy = px * sin + py * cos + rois[..., None, None, 1]
    return torch.stack([(wx - pc_range[0]) / (voxel_size[0] * bev_stride) - 0.5,
                        (wy - pc_range[1]) / (voxel_size[1] * bev_stride) - 0.5], dim=-1)


class SECONDHead(nn.Module):
    def __init__(self, model_cfg, input_channels, point_cloud_range, voxel_size, bev_stride=8):
        super().__init__()
        self.model_cfg = model_cfg
        self.point_cloud_range, self.voxel_size = point_cloud_range, voxel_size
        self.bev_stride = bev_stride
        self.g = int(model_cfg.get("ROI_GRID_SIZE", 7))
        c = self.g * self.g * input_channels
        self.num_fc = 0
        for i, ch in enumerate(int(v) for v in model_cfg.get("SHARED_FC", [256, 256])):
            self.add_module(f"shared_fc_{i}", nn.Linear(c, ch))
            c, self.num_fc = ch, i + 1
        self.iou_head = nn.Linear(c, 1)

    def forward(self, batch_dict):
        fmap = batch_dict["spatial_features_2d"].detach()  # (B, C, H, W)
        rois = batch_dict["rois"].detach()  # (B, N, 7)
        grid = rotated_roi_grid(rois, self.g, self.point_cloud_range, self.bev_stride,
                                self.voxel_size)
        x = bilinear_sample(fmap.permute(0, 2, 3, 1), grid).flatten(2)  # (B, N, G*G*C)
        for i in range(self.num_fc):
            x = torch.relu(getattr(self, f"shared_fc_{i}")(x))
        logit = self.iou_head(x)[..., 0]
        batch_dict["roi_ious"] = torch.sigmoid(logit)
        batch_dict["roi_iou_logits"] = logit
        return batch_dict


def second_head_loss(batch_dict, gt_boxes):
    """Smooth-L1 (beta 0.1) between the predicted IoU and each RoI's best
    3D IoU with a valid gt box (class id in the last column), the mean
    over the global batch's RoIs: (loss, tb)."""
    rois, pred = batch_dict["rois"], batch_dict["roi_ious"]
    with torch.no_grad():
        iou = boxes_iou3d(rois[..., :7].detach(), gt_boxes[..., :7])  # (B, N, M)
        iou = torch.where((gt_boxes[..., -1] > 0)[:, None, :], iou, torch.zeros_like(iou))
        target = iou.max(dim=-1).values
    loss = smooth_l1_loss(pred - target, beta=0.1)
    loss = loss.sum() / (loss.numel() * get_world_size())
    return loss, {"rcnn_loss_iou": loss}


def rescore_detections(cls_scores, iou_scores, num_pts=None, score_type="weighted_iou_cls",
                       iou_weight=0.68):
    """The final score of each RoI by ``score_type``: its class score, its
    IoU score, their mix at ``iou_weight``, or (num_pts_iou_cls) the mix at
    num_pts / 100 clipped to [0.1, 0.9]: few points trust the class."""
    if score_type == "cls":
        return cls_scores
    if score_type == "iou":
        return iou_scores
    if score_type == "weighted_iou_cls":
        return iou_weight * iou_scores + (1 - iou_weight) * cls_scores
    if score_type == "num_pts_iou_cls":
        if num_pts is None:
            raise ValueError("num_pts_iou_cls needs the points in each RoI")
        w = torch.clamp(num_pts.float() / 100.0, 0.1, 0.9)
        return w * iou_scores + (1 - w) * cls_scores
    raise NotImplementedError(score_type)
