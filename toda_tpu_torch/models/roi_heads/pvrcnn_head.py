"""PVRCNNHead — RoI grid pooling over the VSA keypoints and box refinement
(PV-RCNN stage 2).

Counterpart of ``toda_tpu/models/roi_heads/pvrcnn_head.py`` (:18-108) in
eval mode (dropout off): a G x G x G grid of points in each RoI
(``get_global_grid_points_of_roi``), a ``SAGroupMSG`` over the keypoints
with their features weighted by ``point_cls_scores`` (``roi_grid_pool``),
the pooled features flattened G^3-major as JAX reshapes them, shared FCs,
then the cls and reg branches. Module names follow the flax tree.
"""

import torch
from torch import nn

from ...utils.common_utils import rotate_points_along_z_torch
from ..backbones_3d.pfe.voxel_set_abstraction import SAGroupMSG
from ..model_utils.masked_norm import add_fc_stack, fc_stack


def get_dense_grid_points(rois, grid_size):
    """(..., 7) RoIs -> (..., G^3, 3) cell centres in the box frame (JAX
    :18-30); the G^3 order is (x, y, z), x slowest (meshgrid "ij")."""
    g = grid_size
    r = torch.arange(g, dtype=rois.dtype, device=rois.device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    dense_idx = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    size = rois[..., None, 3:6]
    return (dense_idx + 0.5) / g * size - size / 2


def get_global_grid_points_of_roi(rois, grid_size):
    """(B, R, 7+) -> (B, R, G^3, 3) grid points in the world frame: rotated
    by the heading, then moved to the RoI centre (JAX :33-40)."""
    local = get_dense_grid_points(rois[..., :7], grid_size)
    b, r, g3, _ = local.shape
    rot = rotate_points_along_z_torch(local.reshape(b * r, g3, 3),
                                      rois[..., 6].reshape(-1)).reshape(b, r, g3, 3)
    return rot + rois[..., None, 0:3]


class PVRCNNHead(nn.Module):
    def __init__(self, model_cfg, point_feature_channels, num_class=1, code_size=7):
        super().__init__()
        cfg = self.model_cfg = model_cfg
        pool_cfg = cfg["ROI_GRID_POOL"]
        if pool_cfg.get("NAME") == "VectorPoolAggregationModuleMSG":
            raise NotImplementedError("PVRCNNHead: VectorPoolAggregationModuleMSG")
        self.g = int(pool_cfg["GRID_SIZE"])
        self.roi_grid_pool = SAGroupMSG.from_cfg(pool_cfg, 3 + point_feature_channels)
        c = add_fc_stack(self, "shared", self.g ** 3 * self.roi_grid_pool.out_channels,
                         cfg["SHARED_FC"])
        nc = 1 if cfg.get("CLASS_AGNOSTIC", True) else num_class
        for tag, fcs, out_ch in (("cls", cfg["CLS_FC"], nc), ("reg", cfg["REG_FC"], code_size * nc)):
            self.add_module(f"{tag}_out", nn.Linear(add_fc_stack(self, tag, c, fcs), out_ch))
        # flax kernel inits of the two output layers
        self.cls_out.flax_init = "xavier_normal"
        self.reg_out.flax_init = ("normal", 0.001)

    def forward(self, batch_dict):
        rois, roi_mask = batch_dict["rois"], batch_dict["roi_mask"]
        b, r = roi_mask.shape
        g3 = self.g ** 3
        grid = get_global_grid_points_of_roi(rois, self.g).reshape(b, r * g3, 3).contiguous()
        grid_mask = roi_mask[:, :, None].expand(b, r, g3).reshape(b, r * g3)
        feats = batch_dict["point_features"] * batch_dict["point_cls_scores"][..., None]
        pooled = self.roi_grid_pool(batch_dict["point_coords"], batch_dict["point_mask"], feats,
                                    grid, grid_mask)
        h = fc_stack(self, "shared", pooled.reshape(b, r, -1), roi_mask)
        batch_dict["rcnn_cls"] = self.cls_out(fc_stack(self, "cls", h, roi_mask))
        batch_dict["rcnn_reg"] = self.reg_out(fc_stack(self, "reg", h, roi_mask))
        return batch_dict
