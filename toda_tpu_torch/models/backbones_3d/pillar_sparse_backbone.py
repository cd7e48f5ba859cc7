"""BEV-sparse / z-dense 3D backbones: ``PillarBackBone8x`` (SECOND) and
``PillarResBackBone8x`` (CenterPoint-Res) on either conv contract, and the
row-major conv layers of UNetV2 (PartA2).

Counterpart of ``toda_tpu/models/backbones_3d/pillar_sparse_backbone.py``
(``_PillarBackboneBase`` :338-494, ``PillarBackBone8x`` / ``PillarResBackBone8x``
:497-502, ``PillarConvLayerT`` / ``PillarSubMBlockT`` :187-335,
``PillarConvLayer`` / ``PillarSubMBlock`` :64-125). ``FUSED_CONV`` picks the
contract of the 8x backbones, as in JAX:

  * fused (the default): row-major activations (B*P, nz, C). Layers chain
    their RAW conv outputs with a pending BatchNorm affine (scale, shift,
    relu): the next fused conv (kernel K1, ``ops/fused_conv.py``) applies it
    to the rows it gathers, and a residual block's join applies it once. In
    training mode the affine comes from the batch statistics and gradients
    flow back through the fused conv's backward kernels (dx and dW) into the
    statistics.
  * legacy (``FUSED_CONV: False``): the transposed layout (nz*C, B*P), one
    column per pillar, as JAX keeps it. Each layer runs ``pillar_conv3d_t``
    (kernels K7 and K8, ``ops/pillar_sparse.py``), then its BatchNorm
    applied, relu and the mask; the voxelizer's rows are transposed once on
    the way in and the last stage once on the way out.

The row-major layers (``PillarConvLayer``, ``PillarSubMBlock``) run
``pillar_conv3d`` (K9 gathers and a plain z product) and apply their
BatchNorm at once, as JAX's legacy layers do. Parameter and buffer names
mirror the flax tree, the same on both contracts
(``weights.state_dict_from_flax``).
"""

import torch
from torch import nn

from ...ops.fused_conv import fused_bnconv9_ad, out_depth
from ...parallel.mesh import global_count, global_moments
from ..backbones_2d.base_bev_backbone import FLAX_MOMENTUM
from ..model_utils.masked_norm import MaskedBatchNorm
from ...ops.pillar_sparse import (
    bev_downsample_sites,
    bev_inv_down_idx_batched,
    bev_neighbor_idx_sorted_batched,
    fold_idx,
    pillar_conv3d,
    pillar_conv3d_t,
    pillars_to_dense_batched,
    voxelize_pillars_batched,
)


def he_kernel(in_channels, out_channels):
    """A (3, 3, 3, C, Cout) sparse-conv kernel, He-normal as flax inits it."""
    w = torch.empty(3, 3, 3, in_channels, out_channels)
    return nn.Parameter(nn.init.normal_(w, std=(2.0 / (27 * in_channels)) ** 0.5))


class PillarConvLayer(nn.Module):
    """Row-major 3x3x3 conv + masked BatchNorm (+ relu) (``PillarConvLayer``
    :64-91): x (B*P_in, nz, C) -> (B*P_out, nz_out, Cout), zero on invalid
    rows."""

    def __init__(self, in_channels, out_channels, z_stride=1, use_relu=True, identity_tap=None):
        super().__init__()
        self.z_stride, self.use_relu, self.identity_tap = z_stride, use_relu, identity_tap
        self.kernel = he_kernel(in_channels, out_channels)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, x, idxf, out_maskf):
        out = pillar_conv3d(x, idxf, self.kernel.to(x.dtype), out_maskf, self.z_stride,
                            self.identity_tap)
        out = self.bn(out, out_maskf[:, None])
        return torch.relu(out) if self.use_relu else out


class PillarSubMBlock(nn.Module):
    """Submanifold block of row-major convs (``PillarSubMBlock`` :94-125):
    ``num_layers`` convs, or with ``residual`` two convs and an identity
    join. The caller passes the stage's folded submanifold table (JAX
    builds it in each block from a dense BEV map; the sorted lookup gives
    the same table). The residual form's width projection is not ported:
    UNetV2 keeps the width."""

    def __init__(self, in_channels, out_channels, num_layers=2, residual=False):
        super().__init__()
        self.residual = residual
        if residual:
            if in_channels != out_channels:
                raise NotImplementedError("PillarSubMBlock: the residual projection")
            self.conv1 = PillarConvLayer(in_channels, out_channels, identity_tap=4)
            self.conv2 = PillarConvLayer(out_channels, out_channels, use_relu=False,
                                         identity_tap=4)
        else:
            self.num_layers = num_layers
            for i in range(num_layers):
                self.add_module(f"subm{i}", PillarConvLayer(
                    in_channels if i == 0 else out_channels, out_channels, identity_tap=4))

    def forward(self, x, idxf, maskf):
        if self.residual:
            # both terms are zero on invalid rows, so the join is too
            return torch.relu(self.conv2(self.conv1(x, idxf, maskf), idxf, maskf) + x)
        for i in range(self.num_layers):
            x = getattr(self, f"subm{i}")(x, idxf, maskf)
        return x


class MaskedBatchNormT(nn.Module):
    """BatchNorm over valid pillars x z (``MaskedBatchNormT`` :128-163).
    Training: f32 batch statistics of the valid rows (biased variance
    E[x^2] - mean^2, floored at 0), running statistics updated with flax
    momentum 0.99; eval: the running statistics. ``affine`` gives the
    per-channel (scale, shift) for the fused contract's next layer to apply;
    ``forward`` applies it to a transposed (nz, C, M) tensor, as the legacy
    contract does. In a data-parallel run the training statistics are the
    global batch's: the sums and the count are all-reduced across ranks, the
    sums differentiably (``parallel.mesh``; identities at world size 1)."""

    def __init__(self, num_features, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def affine(self, x, maskf, transposed=False):
        """(scale, shift) f32 with y = x * scale + shift, for x (M, nz, C),
        or (nz, C, M) when ``transposed``, and its pillar mask maskf (M,).
        In training they carry gradients back to x through the batch
        statistics."""
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (inv.float().contiguous(),
                    (self.bias - self.running_mean * inv).float().contiguous())
        nz, dims = (x.shape[0], (0, 2)) if transposed else (x.shape[1], (0, 1))
        valid = maskf[None, None, :] if transposed else maskf[:, None, None]
        xf = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device)).float()
        n = torch.clamp(global_count(maskf.sum(dtype=torch.float32)) * nz, min=1.0)
        sums = global_moments(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]))
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv.contiguous(), (self.bias - mean * inv).contiguous()

    def forward(self, x, maskf):
        """x (nz, C, M) normalised in x's dtype (the shift rounded to it
        first), zero on invalid columns."""
        sc, sh = self.affine(x, maskf, transposed=True)
        y = x * sc.to(x.dtype)[:, None] + sh.to(x.dtype)[:, None]
        return torch.where(maskf, y, torch.zeros((), dtype=y.dtype, device=y.device))


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


class PillarConvLayerT(nn.Module):
    """One 3x3x3 conv + masked BatchNorm (``PillarConvLayerT`` :187-257) on
    either contract. A stride-1 layer is a submanifold conv whose centre
    tap (4) is the pillar itself."""

    def __init__(self, in_channels, out_channels, z_stride=1, use_relu=True):
        super().__init__()
        self.z_stride = z_stride
        self.use_relu = use_relu
        self.kernel = he_kernel(in_channels, out_channels)
        self.bn = MaskedBatchNormT(out_channels)

    def forward(self, x, idxf, invf, out_maskf, affine=None):
        """Fused contract (``affine`` = (scale, shift, act), the input's
        pending normalisation): x (M_in, nz, C) raw; returns the raw output
        and the affine of this layer's BatchNorm. Legacy contract (``affine``
        None): x (nz*C, M_in) applied; returns (nz_out*Cout, M_out) after
        BatchNorm, relu and the mask."""
        if affine is not None:
            out = fused_bnconv9_ad(x, affine[0], affine[1],
                                   self.kernel.to(x.dtype).contiguous(), idxf, invf,
                                   self.z_stride, affine[2])
            sc, sh = self.bn.affine(out, out_maskf)
            return out, (sc, sh, self.use_relu)
        c, cout = self.kernel.shape[3:]
        nz = x.shape[0] // c
        out = pillar_conv3d_t(x, idxf, self.kernel.to(x.dtype), out_maskf, nz, self.z_stride,
                              4 if self.z_stride == 1 else None, invf)
        y = self.bn(out.view(-1, cout, out.shape[-1]), out_maskf)
        if self.use_relu:
            y = torch.relu(y)  # the mask keeps: relu(0) is 0
        return y.view(-1, y.shape[-1])


class PillarSubMBlockT(nn.Module):
    """Submanifold block (``PillarSubMBlockT`` :260-335): ``num_layers``
    convs, or with ``residual`` two convs and an identity join (projected
    when the width changes), on either contract."""

    def __init__(self, in_channels, out_channels, residual=False, num_layers=2):
        super().__init__()
        self.residual = residual
        if residual:
            self.conv1 = PillarConvLayerT(in_channels, out_channels)
            self.conv2 = PillarConvLayerT(out_channels, out_channels, use_relu=False)
            self.proj_kernel = None
            if in_channels != out_channels:
                self.proj_kernel = nn.Parameter(torch.empty(in_channels, out_channels))
                nn.init.normal_(self.proj_kernel, std=in_channels ** -0.5)
        else:
            self.num_layers = num_layers
            for i in range(num_layers):
                self.add_module(f"subm{i}", PillarConvLayerT(
                    in_channels if i == 0 else out_channels, out_channels))

    def forward(self, x, idxf, invf, maskf, affine=None):
        """As ``PillarConvLayerT.forward``: with ``affine``, raw rows in and
        (raw rows, affine) out; the residual join returns applied rows with
        an identity affine. Without, applied (nz*C, M) columns in and out."""
        if not self.residual:
            for i in range(self.num_layers):
                layer = getattr(self, f"subm{i}")
                if affine is None:
                    x = layer(x, idxf, invf, maskf)
                else:
                    x, affine = layer(x, idxf, invf, maskf, affine)
            return x if affine is None else (x, affine)
        if affine is not None:
            raw1, aff1 = self.conv1(x, idxf, invf, maskf, affine)
            raw2, aff2 = self.conv2(raw1, idxf, invf, maskf, aff1)
            identity = apply_affine(x, affine, maskf)
            if self.proj_kernel is not None:
                identity = identity @ self.proj_kernel.to(identity.dtype)
            y2 = apply_affine(raw2, aff2, maskf)
            out = torch.where(maskf[:, None, None], torch.relu(y2 + identity),
                              torch.zeros_like(y2))
            return out, identity_affine(out.shape[-1], out.device)
        y2 = self.conv2(self.conv1(x, idxf, invf, maskf), idxf, invf, maskf)
        identity = x
        if self.proj_kernel is not None:
            cin, cout = self.proj_kernel.shape
            id3 = x.view(-1, cin, x.shape[-1])
            identity = torch.matmul(self.proj_kernel.t().to(x.dtype), id3).view(-1, x.shape[-1])
        return torch.where(maskf, torch.relu(y2 + identity), torch.zeros_like(y2))


class _PillarBackboneBase(nn.Module):
    """Voxelize points, then stem + three stride-2 stages (channels
    CHANNELS, 8x BEV stride, z halved per stage), then scatter the last
    stage to a dense (B, nz, ny, nx, C) tensor (``_PillarBackboneBase``
    :338-494). ``FUSED_CONV`` (default True) picks the conv contract."""

    RESIDUAL = False

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
        self.fused = bool(model_cfg.get("FUSED_CONV", True))
        # the voxelizer pads the point features to a multiple of 8 channels
        cin = -(-input_channels // 8) * 8
        self.stage1 = PillarSubMBlockT(cin, chans[0], self.RESIDUAL)
        nz = self.grid_size[2]
        for si, ch in enumerate(chans[1:], start=2):
            self.add_module(f"down{si}", PillarConvLayerT(chans[si - 2], ch, z_stride=2))
            self.add_module(f"stage{si}", PillarSubMBlockT(ch, ch, self.RESIDUAL))
            nz = out_depth(nz, 2)
        self.num_stages = len(chans)
        self.chans = chans
        self.out_channels = chans[-1]
        self.num_bev_features = nz * chans[-1]
        # the stage outputs a consumer reads (VoxelSetAbstraction's x_conv<i>
        # sources); the detector sets it, and no other stage is kept
        self.ms_keys = ()

    def _stage_out(self, ms, si, x, aff, maskf, coords, mask, stride):
        """Stage ``si``'s applied output (the pending affine applied, relu,
        masked; the legacy contract's columns as rows), stored as
        ``ms['x_conv<si>']`` (JAX :425-427, :470-475) when a consumer reads
        it: features (B, P, nz, C) in the activations' dtype, coords (B, P,
        2), mask (B, P), stride and nz. Returns the applied rows (M, nz, C),
        or None when nothing reads the stage and it is not the last."""
        last = si == self.num_stages
        if f"x_conv{si}" not in self.ms_keys and not last:
            return None
        if self.fused:
            rows = apply_affine(x, aff, maskf)
        else:  # (nz*C, B*P) columns -> (B*P, nz, C) rows
            rows = x.view(-1, self.chans[si - 1], x.shape[-1]).permute(2, 0, 1)
        if f"x_conv{si}" in self.ms_keys:
            bt, p = mask.shape
            ms[f"x_conv{si}"] = {"features": rows.reshape(bt, p, rows.shape[1], rows.shape[2]),
                                 "coords": coords, "mask": mask, "stride": stride,
                                 "nz": rows.shape[1]}
        return rows

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
        aff, ms, stride = None, {}, 1
        if self.fused:
            aff = identity_affine(x.shape[-1], x.device)
            x, aff = self.stage1(x, idxf, invf, maskf, aff)
        else:
            c = x.shape[-1]
            # (B*P, nz, C) rows -> (nz*C, B*P) columns, the legacy contract's layout
            x = self.stage1(x.permute(1, 2, 0).reshape(nz * c, -1), idxf, invf, maskf)
        rows = self._stage_out(ms, 1, x, aff, maskf, coords, mask, stride)
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
            down, stage = getattr(self, f"down{si}"), getattr(self, f"stage{si}")
            bev_shape = coarse
            idxf = fold_idx(bev_neighbor_idx_sorted_batched(coords, mask, coords, mask,
                                                            bev_shape, 1), p_out)
            invf = idxf.flip(1).contiguous() if grad else None
            if self.fused:
                x, aff = down(x, fold_idx(nbr, p_in), inv, maskf, aff)
                x, aff = stage(x, idxf, invf, maskf, aff)
            else:
                x = down(x, fold_idx(nbr, p_in), inv, maskf)
                x = stage(x, idxf, invf, maskf)
            stride *= 2
            rows = self._stage_out(ms, si, x, aff, maskf, coords, mask, stride)
        cur_nz, c = rows.shape[1], rows.shape[2]
        dense = pillars_to_dense_batched(rows.reshape(bt, -1, cur_nz, c), coords, mask, bev_shape)
        # (B, D, H, W, C), the layout HeightCompression collapses
        batch_dict["encoded_spconv_tensor"] = dense.permute(0, 3, 1, 2, 4)
        batch_dict["encoded_spconv_tensor_stride"] = stride
        if ms:
            batch_dict["multi_scale_3d_features"] = ms
        return batch_dict


class PillarBackBone8x(_PillarBackboneBase):
    """SECOND's backbone: plain submanifold blocks of two convs."""

    RESIDUAL = False


class PillarResBackBone8x(_PillarBackboneBase):
    """CenterPoint-Res's backbone: residual submanifold blocks."""

    RESIDUAL = True
