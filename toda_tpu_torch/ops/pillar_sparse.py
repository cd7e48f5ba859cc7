"""BEV-sparse / z-dense pillar substrate: voxelizer, downsampled sites,
neighbour tables and the dense scatter.

Counterpart of ``toda_tpu/ops/pillar_sparse.py``. Features are pillars of
dense z columns; a pillar set is (B, P) BEV coords (y, x), ascending by BEV
key y*nx + x, with -1 padding and a validity mask. Everything here is batched
over a leading batch dim. The port's activations are row-major
(B*P, nz, C) ("folded" batch rows).

The JAX module finds neighbour slots by windowed rank counts with a sort
fallback, a TPU workaround for slow gathers; the tables are exact lookups of
a BEV key among the sorted keys, which ``torch.searchsorted`` does directly.
The voxelizer takes the plain f32 mean path of ``voxelize_pillars_batched``
(:236-246); its per-cell sums are kernel K4 and its unpack kernel K5
(``ops/gather.py``). The dense scatter is K4 forward and its exact VJP, the
row gather K6, backward.
"""

import torch

from .gather import gather_rows, scatter_rows_add, unpack_pillars

INT_MAX = 2**31 - 1

# 3x3 BEV taps, t = (dy+1)*3 + (dx+1); tap 4 is the centre
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def _compact_by_rank(head, rank, skey, max_out):
    """out[b, p] = skey[b, row] at the row with head & rank == p, else -1.
    head/rank/skey (B, N) -> (B, max_out)."""
    b = head.shape[0]
    pos = torch.where(head & (rank < max_out), rank, max_out)
    out = torch.full((b, max_out + 1), -1, dtype=skey.dtype, device=skey.device)
    out.scatter_(1, pos, torch.where(head, skey, -1))
    return out[:, :max_out]


def _first_of_runs(skey, valid):
    prev = torch.cat([torch.full_like(skey[:, :1], -1), skey[:, :-1]], dim=1)
    return (skey != prev) & valid


def _coords_of(key, mask, nx):
    safe = torch.where(mask, key, 0)
    yx = torch.stack([torch.div(safe, nx, rounding_mode="floor"), safe % nx], dim=-1)
    return torch.where(mask[..., None], yx, -1).to(torch.int32)


def voxelize_cells(points, points_mask, voxel_size, pc_range, grid_size, max_pillars, nz):
    """Per-sample sort of points by (BEV key, z) and their cell ids
    (``_voxelize_cells`` :148, batched).

    points (B, N, c), points_mask (B, N). Returns dict with spoints (B, N, c)
    sorted, cell (B, N) ascending (max_pillars*nz where dropped), ok (B, N),
    pillar_coords (B, P, 2) int32 and pillar_mask (B, P)."""
    gx, gy, gz = grid_size
    c = points.shape[-1]
    vsize = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    origin = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    ijk = torch.floor((points[..., :3] - origin) / vsize).to(torch.int64)
    valid = (
        points_mask
        & (ijk[..., 0] >= 0) & (ijk[..., 0] < gx)
        & (ijk[..., 1] >= 0) & (ijk[..., 1] < gy)
        & (ijk[..., 2] >= 0) & (ijk[..., 2] < gz)
    )
    bev_key = ijk[..., 1] * gx + ijk[..., 0]
    packed = torch.where(valid, bev_key * gz + ijk[..., 2], INT_MAX)
    spacked, order = torch.sort(packed, dim=1, stable=True)
    spoints = torch.gather(points, 1, order[..., None].expand(-1, -1, c))
    svalid = spacked != INT_MAX
    skey = torch.where(svalid, torch.div(spacked, gz, rounding_mode="floor"), INT_MAX)
    sz = torch.where(svalid, spacked % gz, 0)
    head = _first_of_runs(skey, svalid)
    pillar_idx = torch.cumsum(head.to(torch.int64), dim=1) - 1
    ok = svalid & (pillar_idx < max_pillars)
    cell = torch.where(ok, pillar_idx * nz + sz, max_pillars * nz)
    key_of = _compact_by_rank(head, pillar_idx, skey, max_pillars)
    pillar_mask = key_of >= 0
    return {
        "spoints": spoints, "cell": cell, "ok": ok,
        "pillar_coords": _coords_of(key_of, pillar_mask, gx),
        "pillar_mask": pillar_mask,
    }


def voxelize_pillars_batched(points, points_mask, voxel_size, pc_range, grid_size,
                             max_pillars, nz, out_dtype=torch.float32):
    """Points -> per-cell mean features, the backbone's input.

    Returns dict with x (B*P, nz, cpad) ``out_dtype`` means (channels padded
    with zeros to cpad, the next multiple of 8), pillar_coords (B, P, 2) and
    pillar_mask (B, P). The cell sums are one K4 scatter of
    [features, 1] rows; the mean, pad and cast are one K5 pass."""
    bt, n, c = points.shape
    parts = voxelize_cells(points, points_mask, voxel_size, pc_range, grid_size,
                           max_pillars, nz)
    ok = parts["ok"]
    ncell = max_pillars * nz
    pay = torch.cat([torch.where(ok[..., None], parts["spoints"], 0.0),
                     ok[..., None].to(points.dtype)], dim=-1)
    offs = torch.arange(bt, device=points.device)[:, None] * ncell
    idx = torch.where(ok, parts["cell"] + offs, -1).to(torch.int32).reshape(-1)
    sums = scatter_rows_add(pay.reshape(bt * n, c + 1).contiguous(), idx, bt * ncell)
    cpad = -(-c // 8) * 8
    x = unpack_pillars(sums, c, cpad, out_dtype).reshape(bt * max_pillars, nz, cpad)
    return {"x": x, "pillar_coords": parts["pillar_coords"],
            "pillar_mask": parts["pillar_mask"]}


def bev_downsample_sites(coords, mask, stride, max_out, bev_shape):
    """Occupied coarse BEV cells, ascending key order (:743, batched).
    coords (B, P, 2), mask (B, P) -> (B, max_out, 2) int32, (B, max_out)."""
    ny, nx = bev_shape
    ox = -(-nx // stride)
    coarse = torch.div(coords.to(torch.int64), stride, rounding_mode="floor")
    key = torch.where(mask, coarse[..., 0] * ox + coarse[..., 1], INT_MAX)
    skey, _ = torch.sort(key, dim=1)
    head = _first_of_runs(skey, skey != INT_MAX)
    out_idx = torch.cumsum(head.to(torch.int64), dim=1) - 1
    uniq = _compact_by_rank(head, out_idx, skey, max_out)
    out_mask = uniq >= 0
    return _coords_of(uniq, out_mask, ox), out_mask


def _keys(coords, mask, nx):
    return torch.where(mask, coords[..., 0].to(torch.int64) * nx + coords[..., 1], INT_MAX)


def _lookup(keys, query, ok):
    """Slot of each query key among the ascending keys, -1 where absent or
    not ok. keys (B, P); query/ok (B, Q, T) -> (B, Q, T) int32."""
    b, q, t = query.shape
    flat = torch.where(ok, query, -1).reshape(b, q * t)
    pos = torch.searchsorted(keys, flat)
    found = torch.gather(keys, 1, pos.clamp(max=keys.shape[1] - 1)) == flat
    hit = ok.reshape(b, q * t) & found & (pos < keys.shape[1])
    return torch.where(hit, pos, -1).to(torch.int32).reshape(b, q, t)


def bev_neighbor_idx_sorted_batched(in_coords, in_mask, out_coords, out_mask,
                                    bev_shape, stride=1):
    """(B, P_out, 9) input slots of the 3x3 BEV taps of each output site
    (input site = out * stride + (dy, dx)), -1 missing (:1049)."""
    ny, nx = bev_shape
    keys = _keys(in_coords, in_mask, nx)
    offs = torch.tensor(TAPS, dtype=torch.int64, device=in_coords.device)
    nb = out_coords.to(torch.int64)[:, :, None, :] * stride + offs
    ok = (
        (nb[..., 0] >= 0) & (nb[..., 0] < ny) & (nb[..., 1] >= 0) & (nb[..., 1] < nx)
    ) & out_mask[..., None]
    return _lookup(keys, nb[..., 0] * nx + nb[..., 1], ok)


def bev_inv_down_idx_batched(coarse_coords, coarse_mask, fine_coords, fine_mask,
                             coarse_bev_shape):
    """(B, P_fine, 9) inverse of the stride-2 down table: for each fine site
    and tap t = (dy, dx), the coarse slot o with 2*o + (dy, dx) - 1 == fine,
    -1 where there is none (the transposed conv's table)."""
    ny, nx = coarse_bev_shape
    keys = _keys(coarse_coords, coarse_mask, nx)
    offs = torch.tensor([(dy, dx) for dy in (0, 1, 2) for dx in (0, 1, 2)],
                        dtype=torch.int64, device=fine_coords.device)
    num = fine_coords.to(torch.int64)[:, :, None, :] - (offs - 1)
    o = torch.div(num, 2, rounding_mode="floor")
    ok = (
        (num % 2 == 0).all(dim=-1)
        & (o[..., 0] >= 0) & (o[..., 0] < ny) & (o[..., 1] >= 0) & (o[..., 1] < nx)
        & fine_mask[..., None]
    )
    return _lookup(keys, o[..., 0] * nx + o[..., 1], ok)


def bev_down_tables_batched(fine_coords, fine_mask, coarse_coords, coarse_mask,
                            bev_shape, coarse_bev_shape):
    """The k=3 s=2 forward table (coarse -> fine slots) and its inverse
    (fine -> coarse slots) (:1168)."""
    nbr = bev_neighbor_idx_sorted_batched(fine_coords, fine_mask, coarse_coords,
                                          coarse_mask, bev_shape, 2)
    inv = bev_inv_down_idx_batched(coarse_coords, coarse_mask, fine_coords, fine_mask,
                                   coarse_bev_shape)
    return nbr, inv


def fold_idx(idx, p_in):
    """(B, P_out, T) per-sample tables -> (B*P_out, T) into the folded rows
    (sample b's rows live at [b*p_in, (b+1)*p_in))
    (``pillar_sparse_backbone.py:45``)."""
    bt = idx.shape[0]
    offs = (torch.arange(bt, dtype=torch.int32, device=idx.device) * p_in)[:, None, None]
    return torch.where(idx >= 0, idx + offs, -1).reshape(bt * idx.shape[1], idx.shape[2])


class _DenseScatter(torch.autograd.Function):
    """(M, W) rows -> (n, W) table by unique row keys (-1 dropped), in the
    rows' dtype: K4 forward, the K6 row gather backward
    (``_dense_scatter_diff`` :778-796)."""

    @staticmethod
    def forward(ctx, rows, flat, n):
        ctx.save_for_backward(flat)
        return scatter_rows_add(rows, flat, n).to(rows.dtype)

    @staticmethod
    def backward(ctx, gbar):
        (flat,) = ctx.saved_tensors
        return gather_rows(gbar.contiguous(), flat), None, None


def pillars_to_dense_batched(features, coords, mask, bev_shape):
    """(B, P, nz, C) -> (B, ny, nx, nz, C) dense, by one K4 scatter (:799).
    Keys are unique and ascending per sample, so each dense row gets at most
    one pillar. Differentiable in ``features`` (K6 backward)."""
    ny, nx = bev_shape
    bt, p, nz, c = features.shape
    offs = torch.arange(bt, device=coords.device)[:, None] * (ny * nx)
    flat = torch.where(mask & (coords[..., 0] >= 0),
                       coords[..., 0].to(torch.int64) * nx + coords[..., 1] + offs, -1)
    rows, flat = features.reshape(bt * p, nz * c).contiguous(), flat.to(torch.int32).reshape(-1)
    dense = _DenseScatter.apply(rows, flat, bt * ny * nx)
    return dense.reshape(bt, ny, nx, nz, c)
