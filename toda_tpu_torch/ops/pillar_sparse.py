"""BEV-sparse / z-dense pillar substrate: voxelizer, downsampled sites,
neighbour tables, the dense scatter and the row-major sparse convs.

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
(``ops/gather.py``), both differentiable, so the voxelizer is
differentiable in the points (the pseudo-label perturbation). The dense
scatter is K4 forward and its exact VJP, the row gather K6, backward. The
row-major 3x3x3 conv ``pillar_conv3d``
gathers its taps with K9 and contracts z with a plain product; its
transposed counterpart ``pillar_inv_conv3d`` gathers with K6. The conv of
the transposed layout, ``pillar_conv3d_t`` (activations (nz*C, M), one
column per folded pillar), gathers with K7 and K8 in both directions.
"""

import torch
import torch.nn.functional as F

from .gather import (
    gather9_stacked_t,
    gather_rows,
    gather_rows_taps,
    gather_rows_taps_t,
    scatter_rows_add,
    unpack_pillars,
)

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
                             max_pillars, nz, out_dtype=torch.float32, cpad=None):
    """Points -> per-cell mean features, the backbone's input.

    Returns dict with x (B*P, nz, cpad) ``out_dtype`` means (channels padded
    with zeros to cpad, by default the next multiple of 8), pillar_coords
    (B, P, 2) and pillar_mask (B, P). The cell sums are one K4 scatter of
    [features, 1] rows; the mean, pad and cast are one K5 pass. With
    ``cpad`` = C these are the means of the per-sample ``voxelize_pillars``
    (:67-140), which UNetV2 takes."""
    bt, n, c = points.shape
    gx, gy, gz = grid_size
    if gx * gy * gz >= INT_MAX:
        raise ValueError(f"grid {grid_size}: the packed (BEV key, z) key must fit int32, "
                         "as JAX's does")
    parts = voxelize_cells(points, points_mask, voxel_size, pc_range, grid_size,
                           max_pillars, nz)
    ok = parts["ok"]
    ncell = max_pillars * nz
    pay = torch.cat([torch.where(ok[..., None], parts["spoints"], 0.0),
                     ok[..., None].to(points.dtype)], dim=-1)
    offs = torch.arange(bt, device=points.device)[:, None] * ncell
    idx = torch.where(ok, parts["cell"] + offs, -1).to(torch.int32).reshape(-1)
    sums = scatter_rows_add(pay.reshape(bt * n, c + 1).contiguous(), idx, bt * ncell)
    cpad = -(-c // 8) * 8 if cpad is None else cpad
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
    dense = scatter_rows_add(rows, flat, bt * ny * nx, out_dtype=rows.dtype)
    return dense.reshape(bt, ny, nx, nz, c)


def pillars_to_dense(features, coords, mask, bev_shape):
    """(B, P, nz, C) -> (B, ny, nx, nz, C) dense by one ``index_copy`` (the
    per-sample ``pillars_to_dense`` :764-775, an XLA scatter in JAX)."""
    ny, nx = bev_shape
    bt, p, nz, c = features.shape
    offs = torch.arange(bt, device=coords.device)[:, None] * (ny * nx)
    flat = torch.where(mask & (coords[..., 0] >= 0),
                       coords[..., 0].to(torch.int64) * nx + coords[..., 1] + offs,
                       bt * ny * nx)
    dense = features.new_zeros((bt * ny * nx + 1, nz * c))
    dense.index_copy_(0, flat.reshape(-1), features.reshape(bt * p, nz * c))
    return dense[:-1].reshape(bt, ny, nx, nz, c)


# the 3x3 BEV taps grouped by BEV row (dy): a group's taps differ by +-1 column
TAP_GROUPS = ((0, 1, 2), (3, 4, 5), (6, 7, 8))


def z_conv(g, w, z_stride):
    """Each row's 3-wide z contraction, VALID, stride ``z_stride`` (the
    ``lax.conv_general_dilated`` of ``tap_conv`` :409-419).

    g (M, L, C) rows of L z cells, w (3, C, Cout) -> (M, (L - 3) // s + 1,
    Cout) in g's dtype: out[m, zo] = sum_dz g[m, zo*s + dz] @ w[dz]. The
    rows are viewed as a channels-last (M, C, L, 1) image, so the product is
    one (3, 1) convolution that reads g where it lies. C is padded with
    zero channels (and w with zero rows) to a multiple of 16: cuDNN has no
    fast kernel for UNetV2's 5 input channels, and the padded product is
    the faster one on an H100."""
    if g.shape[-1] % 16:
        pad = -g.shape[-1] % 16
        g, w = F.pad(g, (0, pad)), F.pad(w, (0, 0, 0, pad))
    m, length, c = g.shape
    x = g.view(m, length, 1, c).permute(0, 3, 1, 2)
    y = F.conv2d(x, w.permute(2, 1, 0).unsqueeze(-1).to(g.dtype), stride=(z_stride, 1))
    return y.squeeze(3).transpose(1, 2)


def pillar_conv3d(x, idxf, weights, out_maskf, z_stride=1, identity_tap=None):
    """Row-major 3x3x3 conv (``pillar_conv3d`` :695 / ``_conv_fwd_impl``
    :398-428), forward, on folded rows.

    Args:
        x: (M_in, nz, C) folded input rows.
        idxf: (M_out, 9) int32 folded neighbour table into the input rows,
            -1 missing; tap t = dy*3 + dx.
        weights: (3, 3, 3, C, Cout) in (dz, dy, dx) order, in x's dtype.
        out_maskf: (M_out,) bool.
        z_stride: 1 or 2; identity_tap: the tap whose neighbour is the row
            itself (4 for a submanifold conv), taken on x without a gather.
    Returns (M_out, ceil(nz / z_stride), Cout) in x's dtype, zero on invalid
    rows.

    The input gets one zero z cell on each side (``(M_in, (nz+2)*C)``); one
    K9 launch per dy group gathers the group's taps, and each tap's z
    contraction is a plain product (``z_conv``). Contributions are summed
    in tap order, the identity tap last, as JAX sums them."""
    m_in, nz, c = x.shape
    table = F.pad(x, (0, 0, 1, 1)).reshape(m_in, (nz + 2) * c)
    acc = None
    for grp in TAP_GROUPS:
        taps = [t for t in grp if t != identity_tap]
        gathered = gather_rows_taps(table, idxf[:, taps].contiguous())
        for k, t in enumerate(taps):
            contrib = z_conv(gathered[k].view(-1, nz + 2, c), weights[:, t // 3, t % 3],
                             z_stride)
            acc = contrib if acc is None else acc.add_(contrib)
        del gathered
    if identity_tap is not None:
        dy, dx = divmod(identity_tap, 3)
        acc.add_(z_conv(table.view(m_in, nz + 2, c), weights[:, dy, dx], z_stride))
    return acc.masked_fill_(~out_maskf[:, None, None], 0).contiguous()


def pillar_inv_conv3d(x, inv_idxf, weights, fine_maskf, nz_fine):
    """Transposed 3x3x3 stride-2 conv onto the known fine sites
    (``pillar_inv_conv3d`` :1211-1255), on folded rows.

    Args:
        x: (M_c, nz_c, C) folded coarse rows.
        inv_idxf: (M_f, 9) int32 folded table: for each fine row and tap
            t = dy*3 + dx, the coarse row o with 2*o + (dy, dx) - 1 == fine.
        weights: (3, 3, 3, C, Cout) in (dz, dy, dx) order, in x's dtype.
        fine_maskf: (M_f,) bool; nz_fine: fine z cells.
    Returns (M_f, nz_fine, Cout).

    Nine K6 gathers of the coarse rows; fine z = 2*zc + dz - 1, so dz = 1
    adds to the even fine cells and dz = 0, 2 to the odd ones."""
    m_c, nz_c, c = x.shape
    m_f = inv_idxf.shape[0]
    table = x.reshape(m_c, nz_c * c)
    out = x.new_zeros((m_f, nz_fine, weights.shape[-1]))
    for t in range(9):
        dy, dx = divmod(t, 3)
        g = gather_rows(table, inv_idxf[:, t].contiguous()).view(m_f, nz_c, c)
        for dz in range(3):
            vals = g @ weights[dz, dy, dx]
            if dz == 1:
                n = min(nz_c, (nz_fine + 1) // 2)
                out[:, 0:2 * n:2] += vals[:, :n]
            else:
                zc0 = 1 if dz == 0 else 0
                zf0 = 2 * zc0 + dz - 1
                n = min(nz_c - zc0, max((nz_fine - zf0 + 1) // 2, 0))
                if n > 0:
                    out[:, zf0:zf0 + 2 * n:2] += vals[:, zc0:zc0 + n]
    return out.masked_fill_(~fine_maskf[:, None, None], 0)


def _taps_weights(weights):
    """(3, 3, 3, C, Cout) (dz, dy, dx) -> (9, 3, C, Cout) [tap][dz]."""
    c, cout = weights.shape[3:]
    return weights.permute(1, 2, 0, 3, 4).reshape(9, 3, c, cout)


def _zconv_t(g, taps_w, c, z_stride, acc=None):
    """The z contraction of gathered taps in the transposed layout (the
    ``conv_general_dilated`` of ``_conv_fwd_impl_t`` :545-583).

    g (T, (nz+2)*C, M): each tap's zero-haloed columns, rows [z][C];
    taps_w (T, 3, C, Cout). Returns acc + (nz_out, Cout, M):
    out[zo, co, m] = sum_t sum_dz sum_ci taps_w[t, dz, ci, co]
    g[t, (zo*s + dz)*C + ci, m]. For each tap one batched product over the
    output z reads the 3*C-row window of each zo where it lies (a strided
    view, no copy) and adds into acc. One convolution with the taps as
    input channels and a (3*C, 1) kernel stepping C rows computes the same
    with one rounding, but cuDNN runs it slower on an H100 (``chip_smoke.py``
    times both at stage 1)."""
    g = g.contiguous()  # the windows below are strided views of its storage
    t, rows, m = g.shape
    nz_out = (rows // c - 3) // z_stride + 1
    w = taps_w.permute(0, 3, 1, 2).reshape(t, -1, 3 * c).to(g.dtype)  # (T, Cout, 3C)
    for k in range(t):
        x = g[k].as_strided((nz_out, 3 * c, m), (z_stride * c * m, m, 1))
        wk = w[k].expand(nz_out, -1, -1)
        acc = torch.bmm(wk, x) if acc is None else acc.baddbmm_(wk, x)
    return acc


def _zconv_t_bwd(haloT, g, w_e, nz, z_stride, dx_acc):
    """Both cotangents of one z contraction, from the gathered output
    cotangent (``_core_t_bwd`` :611-669).

    haloT ((nz+2)*C, M_in) the forward's haloed input; g (nz_out, K, M_in)
    the output cotangent gathered to the input columns; w_e (3, C, K) with
    out[zo, k, i] = sum_dz,ci w_e[dz, ci, k] haloT[(zo*s + dz)*C + ci, i].
    Adds the input cotangent to ``dx_acc`` ((nz+2, C, M_in) f32, or None to
    skip it) and returns the weight cotangent (3, C, K) in f32."""
    haloT = haloT.contiguous()  # the windows below are strided views of its storage
    rows, m = haloT.shape
    c = rows // (nz + 2)
    nz_out, k, _ = g.shape
    if dx_acc is not None:
        y = torch.matmul(w_e.reshape(3 * c, k).to(g.dtype), g)  # (nz_out, 3C, M_in)
        span = z_stride * (nz_out - 1) + 1
        for dz in range(3):
            dx_acc[dz:dz + span:z_stride] += y[:, dz * c:(dz + 1) * c]
    # the input windows of every output z, read in place: (nz_out, 3C, M_in)
    x = haloT.as_strided((nz_out, 3 * c, m), (z_stride * c * m, m, 1))
    return torch.matmul(x, g.transpose(1, 2)).float().sum(0).view(3, c, k)


class _PillarConv3dT(torch.autograd.Function):
    """``pillar_conv3d_t``'s custom VJP (``_pillar_conv3d_t_core`` :586-669):
    gathers forward through the neighbour table, and backward through its
    inverse, so no scatter runs in either direction."""

    @staticmethod
    def forward(ctx, flatT, weights, idxf, invf, maskf, nz, z_stride, identity_tap):
        ctx.save_for_backward(flatT, weights, idxf, invf, maskf)
        ctx.nz, ctx.z_stride, ctx.identity_tap = nz, z_stride, identity_tap
        c = flatT.shape[0] // nz
        haloT = F.pad(flatT, (0, 0, c, c))  # one zero z cell (C rows) on each side
        taps_w = _taps_weights(weights)
        if z_stride == 1 and c % 16 == 0:
            # stacked: one K7 launch gathers all 9 taps
            g = gather9_stacked_t(haloT, idxf, identity_tap=identity_tap)
            acc = _zconv_t(g.view(9, -1, idxf.shape[0]), taps_w, c, z_stride)
        else:
            acc = None
            for grp in TAP_GROUPS:  # one K8 launch per dy group
                taps = [t for t in grp if t != identity_tap]
                g = gather_rows_taps_t(haloT, idxf[:, taps].contiguous())
                acc = _zconv_t(g, taps_w[taps], c, z_stride, acc)
                del g
            if identity_tap is not None:
                acc = _zconv_t(haloT[None], taps_w[identity_tap:identity_tap + 1], c,
                               z_stride, acc)
        out = torch.where(maskf, acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
        return out.reshape(-1, out.shape[-1])

    @staticmethod
    def backward(ctx, gout):
        flatT, weights, idxf, invf, maskf = ctx.saved_tensors
        if invf is None:
            raise RuntimeError("pillar_conv3d_t: the backward needs the inverse table invf")
        nz, z_stride, identity_tap = ctx.nz, ctx.z_stride, ctx.identity_tap
        c, m_in = flatT.shape[0] // nz, flatT.shape[1]
        cout = weights.shape[-1]
        nz_out = -(-nz // z_stride)
        ob = torch.where(maskf, gout, torch.zeros((), dtype=gout.dtype, device=gout.device))
        ob = ob.to(flatT.dtype).contiguous()  # (nz_out*Cout, M_out)
        haloT = F.pad(flatT, (0, 0, c, c))
        taps_w = _taps_weights(weights)
        dx = (torch.zeros((nz + 2, c, m_in), dtype=torch.float32, device=flatT.device)
              if ctx.needs_input_grad[0] else None)
        if cout % 16 == 0:
            # one K7 launch through the inverse table, rows [zo][t][Cout]:
            # both cotangents of a 9*Cout-channel z contraction
            g = gather9_stacked_t(ob, invf, chunk=cout, identity_tap=identity_tap)
            w_e = taps_w.permute(1, 2, 0, 3).reshape(3, c, 9 * cout)
            dw_e = _zconv_t_bwd(haloT, g.view(nz_out, 9 * cout, m_in), w_e, nz, z_stride, dx)
            dtaps = dw_e.view(3, c, 9, cout).permute(2, 0, 1, 3)
        else:
            dtaps = torch.zeros((9, 3, c, cout), dtype=torch.float32, device=flatT.device)
            for grp in TAP_GROUPS:  # one K8 launch per dy group
                taps = [t for t in grp if t != identity_tap]
                g = gather_rows_taps_t(ob, invf[:, taps].contiguous())
                for k, t in enumerate(taps):
                    dtaps[t] = _zconv_t_bwd(haloT, g[k].view(nz_out, cout, m_in), taps_w[t],
                                            nz, z_stride, dx)
            if identity_tap is not None:
                dtaps[identity_tap] = _zconv_t_bwd(haloT, ob.view(nz_out, cout, m_in),
                                                   taps_w[identity_tap], nz, z_stride, dx)
        dweights = dtaps.reshape(3, 3, 3, c, cout).permute(2, 0, 1, 3, 4).to(weights.dtype)
        dflat = None if dx is None else dx[1:-1].reshape(nz * c, m_in).to(flatT.dtype)
        return dflat, dweights, None, None, None, None, None, None


def pillar_conv3d_t(flatT, idxf, weights, maskf, nz, z_stride=1, identity_tap=None,
                    inv_idx_f=None):
    """Transposed-layout 3x3x3 conv (``pillar_conv3d_t`` :672-693).

    Args:
        flatT: (nz*C, M_in) activations, one column per folded pillar, rows
            [z][C].
        idxf: (M_out, 9) int32 folded neighbour table into the input
            columns, -1 missing; tap t = dy*3 + dx.
        weights: (3, 3, 3, C, Cout) in (dz, dy, dx) order, in flatT's dtype.
        maskf: (M_out,) bool.
        nz: z cells of the input; z_stride: 1 or 2.
        identity_tap: the tap whose neighbour is the column itself (4 for a
            submanifold conv, where M_in == M_out), copied, not gathered.
        inv_idx_f: (M_in, 9) int32 folded inverse table (inv[i, t] = o with
            idxf[o, t] == i), needed only by the backward. The backbones
            pass it (the mirrored table of a submanifold conv, the
            searchsorted inverse of a strided one), so JAX's scatter that
            derives it (``invert_neighbor_idx``) is not ported.
    Returns (nz_out*Cout, M_out) in flatT's dtype, zero on invalid columns,
    nz_out = ceil(nz / z_stride). Differentiable in flatT and weights.

    The path follows the shapes only: a stride-1 conv with C % 16 == 0
    gathers all 9 taps with one K7 launch and contracts them in one
    product; every other conv gathers each dy group's taps with one K8
    launch. The backward gathers the output cotangent through the inverse
    table with one K7 launch (chunk Cout, when Cout % 16 == 0) or one K8
    launch per dy group, and that one gather feeds both the input and the
    weight cotangents."""
    return _PillarConv3dT.apply(flatT, weights, idxf, inv_idx_f, maskf, nz, z_stride,
                                identity_tap)
