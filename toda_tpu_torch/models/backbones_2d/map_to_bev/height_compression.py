"""Collapse the z axis of the dense 3D features into BEV channels.

Counterpart of ``toda_tpu/models/backbones_2d/map_to_bev/height_compression.py``
with JAX's channel order, z-major: BEV channel d*C + c holds depth d,
channel c (pcdet's order is c*D + d). (B, D, H, W, C) -> (B, D*C, H, W).
"""

from torch import nn


class HeightCompression(nn.Module):
    def forward(self, batch_dict):
        x = batch_dict["encoded_spconv_tensor"]
        b, d, h, w, c = x.shape
        batch_dict["spatial_features"] = x.permute(0, 1, 4, 2, 3).reshape(b, d * c, h, w)
        return batch_dict
