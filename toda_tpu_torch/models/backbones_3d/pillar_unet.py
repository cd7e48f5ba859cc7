"""UNetV2 — sparse-conv encoder/decoder for point-wise features (PartA2).

Counterpart of ``toda_tpu/models/backbones_3d/pillar_unet.py`` on the port's
folded row-major activations (B*P, nz, C): the encoder's 11 row-major convs
(``PillarConvLayer`` / ``PillarSubMBlock``, K9 gathers), the stride-8 dense
tensor for the detection head (``conv_out``, a dense (3, 1, 1) conv at
stride 2 over z in f32, and its flax BatchNorm), and the decoder's lateral,
merge and inverse convs (``PillarInvConvLayer``, K6 gathers) back to stage 1.
Each stage's folded submanifold table is built once and shared by the
stage's blocks. Outputs ``point_features`` / ``point_coords`` /
``point_mask`` over the stage-1 cells and ``encoded_spconv_tensor``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pillar_sparse import (
    bev_downsample_sites,
    bev_inv_down_idx_batched,
    bev_neighbor_idx_sorted_batched,
    fold_idx,
    pillar_inv_conv3d,
    pillars_to_dense,
    voxelize_pillars_batched,
)
from ..backbones_2d.base_bev_backbone import bn_apply, make_bn
from ..model_utils.masked_norm import MaskedBatchNorm
from .pillar_sparse_backbone import PillarConvLayer, PillarSubMBlock, he_kernel


class PillarInvConvLayer(nn.Module):
    """Transposed stride-2 conv onto the fine sites + masked BatchNorm +
    relu (``PillarInvConvLayer`` :32-49)."""

    def __init__(self, in_channels, out_channels, nz_fine):
        super().__init__()
        self.nz_fine = nz_fine
        self.kernel = he_kernel(in_channels, out_channels)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, x, inv_idxf, fine_maskf):
        out = pillar_inv_conv3d(x, inv_idxf, self.kernel.to(x.dtype), fine_maskf, self.nz_fine)
        return torch.relu(self.bn(out, fine_maskf[:, None]))


def flax_same_pad(size, k, s):
    """(lo, hi) padding of flax/XLA "SAME" along one axis: for an even
    total the extra cell goes to the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class UNetV2(nn.Module):
    def __init__(self, model_cfg, input_channels, grid_size, voxel_size, point_cloud_range):
        super().__init__()
        self.grid_size = tuple(int(v) for v in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        chans = list(model_cfg.get("CHANNELS", [16, 32, 64, 64]))
        p0 = int(model_cfg.get("MAX_PILLARS", 32768))
        self.caps = [p0, p0 // 2, p0 // 4, p0 // 8]
        self.dtype = torch.bfloat16 if model_cfg.get("BF16", False) else torch.float32
        self.chans = chans
        nzs = [self.grid_size[2]]
        for _ in chans[1:]:
            nzs.append(-(-nzs[-1] // 2))
        self.nzs = nzs

        self.enc1 = PillarSubMBlock(input_channels, chans[0])
        for si in range(2, len(chans) + 1):
            ch = chans[si - 1]
            self.add_module(f"down{si}", PillarConvLayer(chans[si - 2], ch, z_stride=2))
            self.add_module(f"enc{si}", PillarSubMBlock(ch, ch))
        out_ch = int(model_cfg.get("OUT_CHANNELS", 128))
        self.conv_out = nn.Conv3d(chans[-1], out_ch, (3, 1, 1), stride=(2, 1, 1), bias=False)
        self.conv_out_bn = make_bn(out_ch)
        for k in range(len(chans) - 1, 0, -1):
            ch = chans[k]
            self.add_module(f"up_t{k}", PillarSubMBlock(ch, ch, residual=True))
            self.add_module(f"up_m{k}", PillarSubMBlock(2 * ch, ch, num_layers=1))
            self.add_module(f"up_inv{k}", PillarInvConvLayer(ch, chans[k - 1], nzs[k - 1]))
        self.up_m0 = PillarSubMBlock(2 * chans[0], chans[0], num_layers=1)
        self.num_bev_features = -(-nzs[-1] // 2) * out_ch
        self.num_point_features = chans[0]

    def encoded_tensor(self, x, coords, mask, bev_shape):
        """The last stage scattered dense, then ``conv_out`` + BatchNorm +
        relu in f32 (flax's Conv and BatchNorm without a dtype promote the
        bf16 input to f32): (B, D, H, W, OUT_CHANNELS)."""
        bt, p = mask.shape
        dense = pillars_to_dense(x.view(bt, p, *x.shape[1:]), coords, mask, bev_shape)
        d = dense.permute(0, 4, 3, 1, 2).float()  # (B, C, D, H, W)
        d = F.pad(d, (0, 0, 0, 0) + flax_same_pad(d.shape[2], 3, 2))
        y = F.conv3d(d, self.conv_out.weight, stride=(2, 1, 1))
        y = torch.relu(bn_apply(y.flatten(3), self.conv_out_bn)).view(y.shape)
        return y.permute(0, 2, 3, 4, 1)

    def forward(self, batch_dict):
        nx, ny, nz = self.grid_size
        vox = voxelize_pillars_batched(
            batch_dict["points"], batch_dict["points_mask"], self.voxel_size,
            self.point_cloud_range, (nx, ny, nz), self.caps[0], nz, self.dtype,
            cpad=batch_dict["points"].shape[-1])
        x, coords, mask = vox["x"], vox["pillar_coords"], vox["pillar_mask"]
        bev_shape = (ny, nx)

        # encoder; each stage: (x, coords, mask, bev_shape, folded subm table)
        def subm_table(coords, mask, bev_shape):
            return fold_idx(bev_neighbor_idx_sorted_batched(coords, mask, coords, mask,
                                                            bev_shape, 1), coords.shape[1])

        idxf = subm_table(coords, mask, bev_shape)
        x = self.enc1(x, idxf, mask.reshape(-1))
        stages = [(x, coords, mask, bev_shape, idxf)]
        for si in range(2, len(self.chans) + 1):
            new_coords, new_mask = bev_downsample_sites(coords, mask, 2, self.caps[si - 1],
                                                        bev_shape)
            nbr = bev_neighbor_idx_sorted_batched(coords, mask, new_coords, new_mask,
                                                  bev_shape, 2)
            x = getattr(self, f"down{si}")(x, fold_idx(nbr, coords.shape[1]),
                                           new_mask.reshape(-1))
            coords, mask = new_coords, new_mask
            bev_shape = (-(-bev_shape[0] // 2), -(-bev_shape[1] // 2))
            idxf = subm_table(coords, mask, bev_shape)
            x = getattr(self, f"enc{si}")(x, idxf, mask.reshape(-1))
            stages.append((x, coords, mask, bev_shape, idxf))

        batch_dict["encoded_spconv_tensor"] = self.encoded_tensor(x, coords, mask, bev_shape)

        # decoder: lateral + merge + channel-reduction residual, then the
        # inverse conv up to the finer stage
        up = stages[-1][0]
        for k in range(len(stages) - 1, 0, -1):
            lat_x, lat_coords, lat_mask, lat_shape, lat_idxf = stages[k]
            _, fine_coords, fine_mask, _, _ = stages[k - 1]
            lat_maskf = lat_mask.reshape(-1)
            lateral = getattr(self, f"up_t{k}")(lat_x, lat_idxf, lat_maskf)
            cat = torch.cat([up, lateral], dim=-1)
            merged = getattr(self, f"up_m{k}")(cat, lat_idxf, lat_maskf)
            merged = merged + cat.view(*cat.shape[:2], -1, 2).sum(-1)
            inv = bev_inv_down_idx_batched(lat_coords, lat_mask, fine_coords, fine_mask,
                                           lat_shape)
            up = getattr(self, f"up_inv{k}")(merged, fold_idx(inv, lat_coords.shape[1]),
                                             fine_mask.reshape(-1))

        f_x, f_coords, f_mask, _, f_idxf = stages[0]
        up = self.up_m0(torch.cat([up, f_x], dim=-1), f_idxf, f_mask.reshape(-1))

        # point features over the stage-1 cells, and the cells' centres
        b, p = f_mask.shape
        nz1, c1 = up.shape[1], up.shape[2]
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.point_cloud_range[:3]
        cx = (f_coords[..., 1].float() + 0.5) * vx + x0
        cy = (f_coords[..., 0].float() + 0.5) * vy + y0
        zc = (torch.arange(nz1, dtype=torch.float32, device=up.device) + 0.5) * vz + z0
        coords3 = torch.stack([cx[..., None].expand(b, p, nz1), cy[..., None].expand(b, p, nz1),
                               zc.expand(b, p, nz1)], dim=-1)
        batch_dict["point_features"] = up.view(b, p * nz1, c1).float()
        batch_dict["point_coords"] = coords3.reshape(b, p * nz1, 3)
        batch_dict["point_mask"] = f_mask[..., None].expand(b, p, nz1).reshape(b, p * nz1)
        return batch_dict
