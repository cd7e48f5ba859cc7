"""CenterPoint detection head: forward and top-K box decode, eval mode.

Counterpart of ``toda_tpu/models/dense_heads/center_head.py`` (``SeparateHead``,
the ``CenterHead`` forward, ``generate_predicted_boxes`` :213) in NCHW.
Target assignment and losses come with the training slice. The head runs in
f32. Module names mirror the flax ones.
"""

import torch
from torch import nn

from ...ops.nms import top_k
from ..backbones_2d.base_bev_backbone import bn_eval, conv_same, make_bn


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

    def forward(self, x):
        out = {}
        for name, cfg in self.head_dict.items():
            h = x
            for k in range(cfg["num_conv"] - 1):
                h = torch.relu(bn_eval(conv_same(h, getattr(self, f"{name}_conv{k}")),
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
        x = torch.relu(bn_eval(conv_same(x, self.shared_conv), self.shared_bn))
        batch_dict["center_pred_dicts"] = [
            getattr(self, f"head_{gi}")(x) for gi in range(len(self.head_class_groups()))
        ]
        return batch_dict

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
