"""Collapse the z axis of the dense 3D features into BEV channels.

Counterpart of ``toda_tpu/models/backbones_2d/map_to_bev/height_compression.py``
with JAX's channel order, z-major: BEV channel d*C + c holds depth d,
channel c (pcdet's order is c*D + d). (B, D, H, W, C) -> (B, D*C, H, W),
and its stride over the voxel grid (``spatial_features_stride``).
"""

from torch import nn


class HeightCompression(nn.Module):
    def forward(self, batch_dict):
        x = batch_dict["encoded_spconv_tensor"]
        b, d, h, w, c = x.shape
        batch_dict["spatial_features"] = x.permute(0, 1, 4, 2, 3).reshape(b, d * c, h, w)
        batch_dict["spatial_features_stride"] = batch_dict.get("encoded_spconv_tensor_stride", 8)
        return batch_dict
