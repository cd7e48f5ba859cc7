"""BEV-sparse / z-dense residual 3D backbone (CenterPoint-Res).

Counterpart of ``toda_tpu/models/backbones_3d/pillar_sparse_backbone.py``
(``_PillarBackboneBase`` :338, ``PillarResBackBone8x`` :500) on the port's
row-major activations (B*P, nz, C). Layers chain their RAW conv outputs with a
pending BatchNorm affine (scale, shift, relu): the next fused conv (kernel K1,
``ops/fused_conv.py``) applies it to the rows it gathers, and a residual
block's join applies it once. In training mode the affine comes from the
batch statistics and gradients flow back through the fused conv's backward
kernels (dx and dW) into the statistics. Parameter and buffer names mirror
the flax tree (``weights.state_dict_from_flax``).
"""

import torch
from torch import nn

from ...ops.fused_conv import fused_bnconv9_ad, out_depth
from ..backbones_2d.base_bev_backbone import FLAX_MOMENTUM
from ...ops.pillar_sparse import (
    bev_downsample_sites,
    bev_inv_down_idx_batched,
    bev_neighbor_idx_sorted_batched,
    fold_idx,
    pillars_to_dense_batched,
    voxelize_pillars_batched,
)


class MaskedBatchNormT(nn.Module):
    """BatchNorm over valid pillars x z (``MaskedBatchNormT`` :128) as one
    per-channel affine for the next layer to apply. Training: f32 batch
    statistics of the valid rows (biased variance E[x^2] - mean^2, floored at
    0), running statistics updated with flax momentum 0.99; eval: the running
    statistics."""

    def __init__(self, num_features, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def affine(self, x, maskf):
        """(scale, shift) f32 with y = x * scale + shift, for x (M, nz, C)
        and its row mask maskf (M,). In training they carry gradients back
        to x through the batch statistics."""
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (inv.float().contiguous(),
                    (self.bias - self.running_mean * inv).float().contiguous())
        n = torch.clamp(maskf.sum(dtype=torch.float32) * x.shape[1], min=1.0)
        xf = torch.where(maskf[:, None, None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device)).float()
        mean = xf.sum((0, 1)) / n
        var = torch.clamp((xf * xf).sum((0, 1)) / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv.contiguous(), (self.bias - mean * inv).contiguous()


def identity_affine(c, device):
    """No-op input normalization (raw first layer): act=False."""
    return (torch.ones(c, device=device), torch.zeros(c, device=device), False)


def apply_affine(x, affine, maskf):
    """Materialize a pending affine (``apply_affine_t`` :166): relu(x*scale +
    shift) (relu iff act), zero on invalid rows. x (M, nz, C), maskf (M,)."""
    sc, sh, act = affine
    y = x * sc.to(x.dtype) + sh.to(x.dtype)
    if act:
        y = torch.relu(y)
    return torch.where(maskf[:, None, None], y, torch.zeros_like(y))


class PillarConvLayer(nn.Module):
    """One fused conv (``PillarConvLayerT`` :187, fused contract): takes the
    raw input and its pending affine, returns the raw output and the affine
    of its own BatchNorm."""

    def __init__(self, in_channels, out_channels, z_stride=1, use_relu=True):
        super().__init__()
        self.z_stride = z_stride
        self.use_relu = use_relu
        self.kernel = nn.Parameter(torch.empty(3, 3, 3, in_channels, out_channels))
        nn.init.normal_(self.kernel, std=(2.0 / (27 * in_channels)) ** 0.5)
        self.bn = MaskedBatchNormT(out_channels)

    def forward(self, x, idxf, invf, out_maskf, affine):
        out = fused_bnconv9_ad(x, affine[0], affine[1], self.kernel.to(x.dtype).contiguous(),
                               idxf, invf, self.z_stride, affine[2])
        sc, sh = self.bn.affine(out, out_maskf)
        return out, (sc, sh, self.use_relu)


class PillarResBlock(nn.Module):
    """Residual submanifold block (``PillarSubMBlockT`` :284-311): two fused
    convs, identity (projected when the width changes), one join pass."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv1 = PillarConvLayer(in_channels, out_channels)
        self.conv2 = PillarConvLayer(out_channels, out_channels, use_relu=False)
        if in_channels != out_channels:
            self.proj_kernel = nn.Parameter(torch.empty(in_channels, out_channels))
            nn.init.normal_(self.proj_kernel, std=in_channels ** -0.5)
        else:
            self.proj_kernel = None

    def forward(self, x, idxf, invf, maskf, affine):
        raw1, aff1 = self.conv1(x, idxf, invf, maskf, affine)
        raw2, aff2 = self.conv2(raw1, idxf, invf, maskf, aff1)
        identity = apply_affine(x, affine, maskf)
        if self.proj_kernel is not None:
            identity = identity @ self.proj_kernel.to(identity.dtype)
        y2 = apply_affine(raw2, aff2, maskf)
        out = torch.where(maskf[:, None, None], torch.relu(y2 + identity),
                          torch.zeros_like(y2))
        return out, identity_affine(out.shape[-1], out.device)


class PillarResBackBone8x(nn.Module):
    """Voxelize points, then stem + three stride-2 stages (channels
    CHANNELS, 8x BEV stride, z halved per stage), then scatter the last
    stage to a dense (B, nz, ny, nx, C) tensor."""

    def __init__(self, model_cfg, input_channels, grid_size, voxel_size, point_cloud_range):
        super().__init__()
        self.grid_size = tuple(int(v) for v in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        chans = list(model_cfg.get("CHANNELS", [16, 32, 64, 64]))
        p0 = int(model_cfg.get("MAX_PILLARS", 32768))
        caps = model_cfg.get("MAX_PILLARS_PER_STAGE", None)
        self.caps = [int(v) for v in caps] if caps is not None else [p0, p0 // 2, p0 // 4, p0 // 8]
        self.dtype = torch.bfloat16 if model_cfg.get("BF16", True) else torch.float32
        # the voxelizer pads the point features to a multiple of 8 channels
        cin = -(-input_channels // 8) * 8
        self.stage1 = PillarResBlock(cin, chans[0])
        nz = self.grid_size[2]
        for si, ch in enumerate(chans[1:], start=2):
            self.add_module(f"down{si}", PillarConvLayer(chans[si - 2], ch, z_stride=2))
            self.add_module(f"stage{si}", PillarResBlock(ch, ch))
            nz = out_depth(nz, 2)
        self.num_stages = len(chans)
        self.num_bev_features = nz * chans[-1]

    def forward(self, batch_dict):
        nx, ny, nz = self.grid_size
        vox = voxelize_pillars_batched(
            batch_dict["points"], batch_dict["points_mask"], self.voxel_size,
            self.point_cloud_range, (nx, ny, nz), self.caps[0], nz, self.dtype)
        x, coords, mask = vox["x"], vox["pillar_coords"], vox["pillar_mask"]
        bt, p = mask.shape
        bev_shape = (ny, nx)
        maskf = mask.reshape(-1)
        # the inverse tables feed only the input-gradient kernels
        grad = torch.is_grad_enabled()
        idxf = fold_idx(bev_neighbor_idx_sorted_batched(coords, mask, coords, mask,
                                                        bev_shape, 1), p)
        # submanifold: the inverse of tap t is column 8 - t of the same table
        invf = idxf.flip(1).contiguous() if grad else None
        x, aff = self.stage1(x, idxf, invf, maskf, identity_affine(x.shape[-1], x.device))
        for si in range(2, self.num_stages + 1):
            p_in, p_out = coords.shape[1], self.caps[si - 1]
            new_coords, new_mask = bev_downsample_sites(coords, mask, 2, p_out, bev_shape)
            coarse = (-(-bev_shape[0] // 2), -(-bev_shape[1] // 2))
            nbr = bev_neighbor_idx_sorted_batched(coords, mask, new_coords, new_mask,
                                                  bev_shape, 2)
            inv = fold_idx(bev_inv_down_idx_batched(new_coords, new_mask, coords, mask, coarse),
                           p_out) if grad else None
            coords, mask = new_coords, new_mask
            maskf = mask.reshape(-1)
            x, aff = getattr(self, f"down{si}")(x, fold_idx(nbr, p_in), inv, maskf, aff)
            bev_shape = coarse
            idxf = fold_idx(bev_neighbor_idx_sorted_batched(coords, mask, coords, mask,
                                                            bev_shape, 1), p_out)
            invf = idxf.flip(1).contiguous() if grad else None
            x, aff = getattr(self, f"stage{si}")(x, idxf, invf, maskf, aff)
        x = apply_affine(x, aff, maskf)
        cur_nz, c = x.shape[1], x.shape[2]
        dense = pillars_to_dense_batched(x.reshape(bt, -1, cur_nz, c), coords, mask, bev_shape)
        # (B, D, H, W, C), the layout HeightCompression collapses
        batch_dict["encoded_spconv_tensor"] = dense.permute(0, 3, 1, 2, 4)
        return batch_dict
