"""VoxelSetAbstraction — PV-RCNN's keypoint features.

Counterpart of ``toda_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py``
(:25-220) with ``SAMPLE_METHOD: FPS`` on the pillar substrate: FPS
keypoints of the raw points (kernel FPS), features sampled from the BEV map
(``bilinear_interpolate``, clamped to the map) and set-abstracted from the
raw points and the backbone's ``x_conv<i>`` stage outputs (``SAGroupMSG``:
a ball query per radius (kernel BQ), a shared MLP, a masked max-pool), then
one fusion layer. Every z-site of a kept pillar is a source point
(``_voxel_source_points``), masked by the pillar mask only.

One repair (F12): JAX computes the voxel centres in the features' dtype,
bf16 under ``BF16: True``, so a coordinate rounds by up to a metre; the port
computes them in f32, as pcdet does. On the f32 path the two agree.
Module names follow the flax tree (``sa_<source>/g{g}_fc{i}``, ``fusion_fc``).
"""

import torch
from torch import nn

from ....ops.pointnet2_ops import farthest_point_sampling, query_and_group
from ...model_utils.masked_norm import MaskedBatchNorm


def bilinear_interpolate(im, x, y):
    """im (C, H, W), one scan of the port's channels-first BEV map; x, y
    (K,) fractional pixel coordinates -> (K, C) f32. The four neighbours'
    indices are clipped to the map, and the weights use the clipped x1, y1,
    as JAX's (:25-44) does; SECONDHead's sampler instead zeroes a neighbour
    off the map."""
    c, h, w = im.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    flat = im.reshape(c, h * w)

    def at(yy, xx):
        return flat.index_select(1, yy * w + xx).t().float()

    wa = (x1.to(x.dtype) - x) * (y1.to(y.dtype) - y)
    wb = (x1.to(x.dtype) - x) * (y - y0.to(y.dtype))
    wc = (x - x0.to(x.dtype)) * (y1.to(y.dtype) - y)
    wd = (x - x0.to(x.dtype)) * (y - y0.to(y.dtype))
    return (at(y0, x0) * wa[:, None] + at(y1, x0) * wb[:, None] + at(y0, x1) * wc[:, None]
            + at(y1, x1) * wd[:, None])


class SAGroupMSG(nn.Module):
    """Multi-scale-grouping set abstraction (JAX ``SAGroupMSG`` :47-80): for
    each (radius, nsample, mlp) a ball query and grouping of ``[xyz -
    query, features]`` rows, a shared MLP of (Linear, masked BatchNorm,
    relu) over the valid slots, and a max-pool over the valid slots (zeros
    for a query with no neighbour); the groups' outputs concatenated."""

    def __init__(self, in_channels, mlps, radii, nsamples):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.depths = []
        for g, mlp in enumerate(mlps):
            cin = in_channels
            for li, ch in enumerate(int(c) for c in mlp):
                self.add_module(f"g{g}_fc{li}", nn.Linear(cin, ch, bias=False))
                self.add_module(f"g{g}_bn{li}", MaskedBatchNorm(ch))
                cin = ch
            self.depths.append(len(mlp))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    @classmethod
    def from_cfg(cls, cfg, in_channels):
        return cls(in_channels, cfg["MLPS"], cfg["POOL_RADIUS"], cfg["NSAMPLE"])

    def forward(self, xyz, xyz_mask, feats, new_xyz, new_mask):
        """xyz (B, N, 3) + mask, feats (B, N, C) or None, new_xyz (B, M, 3)
        + mask -> (B, M, out_channels)."""
        outs = []
        for g, (radius, ns) in enumerate(zip(self.radii, self.nsamples)):
            h, slot_valid = query_and_group(radius, ns, xyz, xyz_mask, new_xyz, new_mask, feats)
            for li in range(self.depths[g]):
                h = torch.relu(getattr(self, f"g{g}_bn{li}")(getattr(self, f"g{g}_fc{li}")(h),
                                                             slot_valid))
            pooled = h.masked_fill(~slot_valid[..., None], float("-inf")).amax(dim=2)
            outs.append(torch.where(slot_valid.any(dim=2)[..., None], pooled,
                                    torch.zeros((), dtype=pooled.dtype, device=pooled.device)))
        return torch.cat(outs, dim=-1)


def _voxel_source_points(ms, voxel_size, pc_range, grid_nz):
    """A ``multi_scale_3d_features`` entry of the pillar substrate -> (B,
    P*nz, 3) f32 centres, (B, P*nz, C) f32 features, (B, P*nz) mask (JAX
    :83-113): every z-site of each pillar, masked by the pillar mask. The
    centres are computed in f32 whatever the features' dtype (F12)."""
    feats, coords, mask = ms["features"], ms["coords"], ms["mask"]
    stride = int(ms["stride"])
    b, p, nzs, c = feats.shape
    z_stride = max(grid_nz // nzs, 1)
    vx, vy, vz = (float(v) for v in voxel_size)
    x0, y0, z0 = (float(v) for v in pc_range[:3])
    cx = (coords[..., 1].float() + 0.5) * (vx * stride) + x0
    cy = (coords[..., 0].float() + 0.5) * (vy * stride) + y0
    zc = (torch.arange(nzs, dtype=torch.float32, device=feats.device) + 0.5) * (vz * z_stride) + z0
    xyz = torch.stack([cx[..., None].expand(b, p, nzs), cy[..., None].expand(b, p, nzs),
                       zc.expand(b, p, nzs)], dim=-1).reshape(b, p * nzs, 3)
    m = mask[..., None].expand(b, p, nzs).reshape(b, p * nzs)
    return xyz, feats.reshape(b, p * nzs, c).float(), m


class VoxelSetAbstraction(nn.Module):
    """FPS keypoints of the raw points, their features from the sources of
    ``FEATURES_SOURCE`` ('bev', 'raw_points', 'x_conv<i>'), concatenated in
    JAX's order (bev, raw points, then the x_conv sources in config order)
    as ``point_features_before_fusion``, and ``fusion_fc`` / ``fusion_bn`` /
    relu over them as ``point_features``."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range, grid_size,
                 num_rawpoint_features, bev_channels, ms_channels):
        super().__init__()
        cfg = self.model_cfg = model_cfg
        if cfg.get("SAMPLE_METHOD", "FPS") != "FPS" \
                or cfg.get("POINT_SOURCE", "raw_points") != "raw_points":
            raise NotImplementedError("VoxelSetAbstraction: only SAMPLE_METHOD FPS over "
                                      "raw_points is ported")
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_nz = int(grid_size[2])
        self.sources = list(cfg["FEATURES_SOURCE"])
        self.ms_keys = tuple(s for s in self.sources if s.startswith("x_conv"))
        width = bev_channels if "bev" in self.sources else 0
        for src in ["raw_points"] * ("raw_points" in self.sources) + list(self.ms_keys):
            sa_cfg = cfg["SA_LAYER"][src]
            if sa_cfg.get("NAME") == "VectorPoolAggregationModuleMSG":
                raise NotImplementedError("VoxelSetAbstraction: VectorPoolAggregationModuleMSG")
            c = num_rawpoint_features - 3 if src == "raw_points" else ms_channels[src]
            sa = SAGroupMSG.from_cfg(sa_cfg, 3 + c)
            self.add_module(f"sa_{src}", sa)
            width += sa.out_channels
        self.num_point_features_before_fusion = width
        out = int(cfg["NUM_OUTPUT_FEATURES"])
        self.fusion_fc = nn.Linear(width, out, bias=False)
        self.fusion_bn = MaskedBatchNorm(out)

    def forward(self, batch_dict):
        points, points_mask = batch_dict["points"], batch_dict["points_mask"]
        xyz = points[..., :3].contiguous()
        kp_idx = farthest_point_sampling(xyz, points_mask, int(self.model_cfg["NUM_KEYPOINTS"]))
        kp_idx = kp_idx.long()
        keypoints = torch.gather(xyz, 1, kp_idx[..., None].expand(-1, -1, 3))
        kp_mask = torch.gather(points_mask, 1, kp_idx)

        feats = []
        if "bev" in self.sources:
            bev = batch_dict["spatial_features"]  # (B, C, H, W)
            stride = float(batch_dict.get("spatial_features_stride", 8))
            x0, y0 = self.point_cloud_range[:2]
            xi = (keypoints[..., 0] - x0) / self.voxel_size[0] / stride
            yi = (keypoints[..., 1] - y0) / self.voxel_size[1] / stride
            feats.append(torch.stack([bilinear_interpolate(bev[i], xi[i], yi[i])
                                      for i in range(bev.shape[0])]))
        if "raw_points" in self.sources:
            raw = points[..., 3:].float() if points.shape[-1] > 3 else None
            feats.append(self.sa_raw_points(xyz, points_mask, raw, keypoints, kp_mask))
        for src in self.ms_keys:
            sxyz, sfeats, smask = _voxel_source_points(
                batch_dict["multi_scale_3d_features"][src], self.voxel_size,
                self.point_cloud_range, self.grid_nz)
            feats.append(getattr(self, f"sa_{src}")(sxyz, smask, sfeats, keypoints, kp_mask))

        pf = torch.cat(feats, dim=-1)
        batch_dict["point_features_before_fusion"] = pf
        batch_dict["point_features"] = torch.relu(self.fusion_bn(self.fusion_fc(pf), kp_mask))
        batch_dict["point_coords"] = keypoints
        batch_dict["point_mask"] = kp_mask
        return batch_dict
