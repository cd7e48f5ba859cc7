"""CenterPoint detection head: forward, targets and loss, top-K box decode.

Counterpart of ``toda_tpu/models/dense_heads/center_head.py`` (``SeparateHead``,
the ``CenterHead`` forward, ``assign_targets`` :106, ``get_loss`` :191,
``generate_predicted_boxes`` :213) with NCHW head maps; the targets keep JAX's
NHWC heatmaps. The head runs in f32. Module names mirror the flax ones.
"""

import torch
from torch import nn

from ...ops.nms import top_k
from ...utils import loss_utils
from ..backbones_2d.base_bev_backbone import bn_apply, conv_same, make_bn

HM_INIT_BIAS = -2.19  # the heatmap conv's initial bias (flax SeparateHead.init_bias)


def gaussian_radius(det_size, min_overlap=0.5):
    """Radius such that a shifted box still overlaps IoU >= min_overlap
    (the 3-case CenterNet formula, :20)."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


class SeparateHead(nn.Module):
    def __init__(self, in_channels, head_dict):
        super().__init__()
        self.head_dict = head_dict  # name -> {out_channels, num_conv}
        for name, cfg in head_dict.items():
            for k in range(cfg["num_conv"] - 1):
                self.add_module(f"{name}_conv{k}", nn.Conv2d(in_channels, in_channels, 3,
                                                             bias=False))
                self.add_module(f"{name}_bn{k}", make_bn(in_channels))
            self.add_module(f"{name}_out", nn.Conv2d(in_channels, cfg["out_channels"], 3))
        self.hm_out.flax_bias_init = HM_INIT_BIAS

    def forward(self, x):
        out = {}
        for name, cfg in self.head_dict.items():
            h = x
            for k in range(cfg["num_conv"] - 1):
                h = torch.relu(bn_apply(conv_same(h, getattr(self, f"{name}_conv{k}")),
                                       getattr(self, f"{name}_bn{k}")))
            out[name] = conv_same(h, getattr(self, f"{name}_out"))
        return out


class CenterHead(nn.Module):
    def __init__(self, model_cfg, input_channels, class_names, grid_size, point_cloud_range,
                 voxel_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.class_names = tuple(class_names)
        self.grid_size = tuple(grid_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        shared_ch = model_cfg.get("SHARED_CONV_CHANNEL", 64)
        self.shared_conv = nn.Conv2d(input_channels, shared_ch, 3, bias=False)
        self.shared_bn = make_bn(shared_ch)
        head_order = model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"]
        head_dict_cfg = model_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]
        for gi, group in enumerate(self.head_class_groups()):
            hd = {"hm": {"out_channels": len(group), "num_conv": 2}}
            for name in head_order:
                hd[name] = dict(head_dict_cfg[name])
            self.add_module(f"head_{gi}", SeparateHead(shared_ch, hd))

    def head_class_groups(self):
        groups = self.model_cfg.get("CLASS_NAMES_EACH_HEAD", None)
        if groups is None:
            groups = [list(self.class_names)]
        return [[c for c in g if c in self.class_names] for g in groups]

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]
        x = torch.relu(bn_apply(conv_same(x, self.shared_conv), self.shared_bn))
        batch_dict["center_pred_dicts"] = [
            getattr(self, f"head_{gi}")(x) for gi in range(len(self.head_class_groups()))
        ]
        return batch_dict

    def assign_targets(self, gt_boxes):
        """gt_boxes (B, M, 8+) padded, class id in the last column (0 =
        padding). Returns per head group a dict: heatmap (B, H, W, nc) f32,
        ind (B, M) int32, mask (B, M) bool, box_targets (B, M, 8[+2]),
        local_cls (B, M) (:106-189)."""
        cfg = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        stride = cfg.get("FEATURE_MAP_STRIDE", 1)
        nx, ny = int(self.grid_size[0]) // stride, int(self.grid_size[1]) // stride
        vx, vy = self.voxel_size[0] * stride, self.voxel_size[1] * stride
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        min_radius = cfg.get("MIN_RADIUS", 2)
        overlap = cfg.get("GAUSSIAN_OVERLAP", 0.1)
        gt = gt_boxes.float()
        dev = gt.device
        targets = []
        for group in self.head_class_groups():
            cls_ids = torch.tensor([self.class_names.index(c) + 1 for c in group],
                                   dtype=torch.int32, device=dev)
            gcls = gt[..., -1].to(torch.int32)
            eq = gcls[..., None] == cls_ids
            local_cls = torch.argmax(eq.to(torch.int32), dim=-1)
            cx = (gt[..., 0] - x0) / vx
            cy = (gt[..., 1] - y0) / vy
            xi = torch.floor(cx).to(torch.int32)
            yi = torch.floor(cy).to(torch.int32)
            valid = (eq.any(-1) & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
                     & (gcls > 0))
            radius = gaussian_radius((gt[..., 4] / vy, gt[..., 3] / vx), min_overlap=overlap)
            radius = torch.clamp(torch.floor(radius), min=min_radius)[..., None, None]
            # every object's gaussian over the whole map, max-combined per class
            ys = torch.arange(ny, dtype=torch.float32, device=dev)[:, None]
            xs = torch.arange(nx, dtype=torch.float32, device=dev)[None, :]
            ddx = xs - xi.float()[..., None, None]
            ddy = ys - yi.float()[..., None, None]
            sigma = (2 * radius + 1) / 6.0
            g = torch.exp(-(ddx ** 2 + ddy ** 2) / (2 * sigma ** 2))
            keep = (ddx.abs() <= radius) & (ddy.abs() <= radius) & valid[..., None, None]
            g = torch.where(keep, g, torch.zeros((), device=dev))  # (B, M, ny, nx)
            onehot = nn.functional.one_hot(local_cls.long(), len(group)).to(g.dtype)
            heatmap = (g[..., None] * onehot[:, :, None, None, :]).amax(dim=1)
            ind = torch.where(valid, yi * nx + xi, 0)
            tgt = torch.stack([
                cx - xi.float(), cy - yi.float(), gt[..., 2],
                torch.log(torch.clamp(gt[..., 3], min=1e-3)),
                torch.log(torch.clamp(gt[..., 4], min=1e-3)),
                torch.log(torch.clamp(gt[..., 5], min=1e-3)),
                torch.cos(gt[..., 6]), torch.sin(gt[..., 6]),
            ], dim=-1)
            if gt.shape[-1] > 9:  # velocity channels present
                tgt = torch.cat([tgt, gt[..., 7:9]], dim=-1)
            targets.append({"heatmap": heatmap, "ind": ind.to(torch.int32), "mask": valid,
                            "box_targets": tgt, "local_cls": local_cls})
        return targets

    def get_loss(self, batch_dict, gt_boxes):
        """Heatmap focal + regression L1 loss over the head groups (:191-211).
        Returns (total, tb dict of scalar tensors)."""
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        head_order = self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"]
        targets = self.assign_targets(gt_boxes)
        total, tb = 0.0, {}
        for gi, (pred, tgt) in enumerate(zip(batch_dict["center_pred_dicts"], targets)):
            hm_pred = torch.sigmoid(pred["hm"]).permute(0, 2, 3, 1)
            hm_loss = loss_utils.focal_loss_centernet(hm_pred, tgt["heatmap"])
            reg_pred = torch.cat([pred[k] for k in head_order], dim=1)
            b, d = reg_pred.shape[:2]
            reg_loss = loss_utils.reg_loss_centernet(
                reg_pred.permute(0, 2, 3, 1).reshape(b, -1, d), tgt["box_targets"],
                tgt["ind"], tgt["mask"])
            total = total + hm_loss * lw["cls_weight"] + reg_loss * lw["loc_weight"]
            tb[f"hm_loss_head_{gi}"] = hm_loss
            tb[f"loc_loss_head_{gi}"] = reg_loss
        tb["rpn_loss"] = total
        return total, tb

    def generate_predicted_boxes(self, batch_dict, max_obj=128):
        """Top-K decode over all head groups -> (B, K, 7) boxes, (B, K)
        scores, (B, K) labels. Scores are ranked over the NHWC-flattened
        (H*W*nc) heatmap, as in JAX, with ties to the lower index."""
        stride = self.model_cfg["TARGET_ASSIGNER_CONFIG"].get("FEATURE_MAP_STRIDE", 1)
        nx = int(self.grid_size[0]) // stride
        vx, vy = self.voxel_size[0] * stride, self.voxel_size[1] * stride
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        head_order = self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"]

        boxes_all, scores_all, labels_all = [], [], []
        for pred, group in zip(batch_dict["center_pred_dicts"], self.head_class_groups()):
            scores = torch.sigmoid(pred["hm"]).permute(0, 2, 3, 1)  # (B, H, W, nc)
            b = scores.shape[0]
            flat = scores.reshape(b, -1)
            top_scores, top_idx = top_k(flat, min(max_obj, flat.shape[1]))
            nc = len(group)
            spatial = torch.div(top_idx, nc, rounding_mode="floor")
            local_cls = top_idx % nc
            yi = torch.div(spatial, nx, rounding_mode="floor")
            xi = spatial % nx

            reg_pred = torch.cat([pred[k] for k in head_order], dim=1)
            d = reg_pred.shape[1]
            reg_flat = reg_pred.permute(0, 2, 3, 1).reshape(b, -1, d)
            reg = torch.gather(reg_flat, 1, spatial[..., None].expand(-1, -1, d))

            xs = (xi.float() + reg[..., 0]) * vx + x0
            ys = (yi.float() + reg[..., 1]) * vy + y0
            dims = torch.exp(torch.clamp(reg[..., 3:6], -5, 5))
            rot = torch.atan2(reg[..., 7], reg[..., 6])
            parts = [xs[..., None], ys[..., None], reg[..., 2:3], dims, rot[..., None]]
            if d > 8:
                parts.append(reg[..., 8:10])  # velocity
            boxes_all.append(torch.cat(parts, dim=-1))
            scores_all.append(top_scores)
            ids = torch.tensor([self.class_names.index(c) + 1 for c in group],
                               dtype=torch.int64, device=top_idx.device)
            labels_all.append(ids[local_cls])
        return (torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1),
                torch.cat(labels_all, dim=1))
