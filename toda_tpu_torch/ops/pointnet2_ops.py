"""PointNet++ point ops, batched over scans with validity masks: farthest
point sampling (kernel FPS), ball query (kernel BQ) and the grouping that
reads the ball query's neighbours.

Counterpart of ``toda_tpu/ops/pointnet2_ops.py``: ``farthest_point_sampling``
(:22-44), ``ball_query`` (:48-66) and ``query_and_group`` (:104-119; the
chunked form :123-147 is the ``chunk`` argument, which bounds the plain
ball query's (chunk, N) distance matrix). JAX vmaps the per-scan functions;
here every function takes a leading batch dimension. The JAX package has no
Pallas kernel for either op: its plain jnp is a ~6-op loop body a step for
FPS (4095 dependent steps) and a (chunk, N) distance matrix for the ball
query. On the H100 both are CUDA kernels (``csrc/pointnet2.cu``, whose
header says how each is built and what bounds it), because the plain
versions cost ~25k launches a batch (FPS) and gigabytes of distance
matrices (ball query). Both bin their points first. The ball query sorts
the candidates into a grid of cells at least the radius wide
(``ball_query_grid`` is the binning's plain version), so a query tests only
the candidates of its 27 cells. FPS sorts each scan by Morton code
(``fps_sort_keys``) and keeps the bounding box of each group of consecutive
sorted points, so a step updates only the groups whose box lies within
their running distance of the sample (``farthest_point_sampling_buckets``
is that algorithm in PyTorch, with the proof that a skip changes nothing).
Both give indices equal to their plain versions: the squared distance is
``(dx*dx + dy*dy) + dz*dz`` in f32, rounded after each operation, the
radius test ``d2 < float32(radius**2)``, and argmax ties go to the lower
index.

Each wrapper runs its plain PyTorch version for tensors on the CPU,
launches its kernel for CUDA tensors (or raises), and counts its launches
in ``LAUNCHES[<wrapper name>]``.
"""

import ctypes

import numpy as np
import torch

from . import _build

BIG = 1e9
LAUNCHES = {"farthest_point_sampling": 0, "ball_query": 0}
# FPS (pointnet2.cu fps_kernel): a scan is one cluster of FPS_CTAS blocks
# over its points in Morton order (``fps_sort_keys``); a thread keeps a group
# of consecutive sorted points with their bounding box and skips a step's
# update where the box proves that no distance changes. A point's key packs
# its running distance, FPS_IDX_BITS of its inverted index and FPS_POS_BITS
# of its slot in its block (``fps_key``), so N is at most FPS_MAX_POINTS.
FPS_CTAS = 16
FPS_IDX_BITS = 18
FPS_POS_BITS = 14
FPS_MAX_POINTS = 2 ** FPS_IDX_BITS
FPS_CODE_BITS = 31  # a scan's sort code: 30 Morton bits and the invalid flag
FPS_CELLS = 1024  # cells an axis of the sort's grid
# BQ (pointnet2.cu ball_query_grid_kernel): a warp keeps a query's nsample
# smallest in-ball indices, up to 4 a lane; the grid's cell side is at least
# the radius times 1 + BQ_CELL_MARGIN, with at most BQ_MAX_CELLS cells an
# axis, fewer where b scans' keys would reach 2**31 (``bq_axis_cells``)
BQ_MAX_NSAMPLE = 128
BQ_CELL_MARGIN = 2.0 ** -10
BQ_MAX_CELLS = 2048
_bound = False


def _lib():
    global _bound
    lib = _build.library("pointnet2.cu")
    if not _bound:
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.toda_fps.argtypes = [p, p, p, p, ctypes.c_size_t, i32, i32, i32, i32, p]
        lib.toda_fps.restype = i32
        lib.toda_fps_workspace.argtypes = [i32, i32]
        lib.toda_fps_workspace.restype = ctypes.c_size_t
        lib.toda_ball_query_workspace.argtypes = [i32, i32]
        lib.toda_ball_query_workspace.restype = ctypes.c_size_t
        lib.toda_ball_query.argtypes = [p, p, p, p, p, p, p, ctypes.c_size_t, i32, i32, i32, f32,
                                        f32, i32, i32, p]
        lib.toda_ball_query.restype = i32
        _bound = True
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def radius_sq(radius):
    """The f32 squared radius both packages compare with: JAX squares the
    Python float in double and compares with an f32 array, so the bound is
    float32(radius**2)."""
    return float(np.float32(float(radius) ** 2))


def sq_dist(a, b):
    """(dx*dx + dy*dy) + dz*dz of a - b over the last dim (3), each
    operation rounded to f32, as the kernels compute it."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _check_xyz(t, what, batch=None):
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3 \
            or not t.is_contiguous() or (batch is not None and t.shape[0] != batch):
        raise ValueError(f"{what} must be a contiguous (B, N, 3) f32 CUDA tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_mask(m, shape, dev, what):
    if m.dtype != torch.bool or tuple(m.shape) != tuple(shape) or m.device != dev \
            or not m.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} bool tensor on {dev}")


def farthest_point_sampling_plain(points, mask, num_samples):
    """Plain PyTorch FPS (JAX :22-44): points (B, N, 3) f32, mask (B, N)
    -> (B, num_samples) int32. Starts at the first valid point; running
    distances start at 1e9 and invalid points sit at -1e9; each step takes
    the argmax (the lowest index among equal maxima). With fewer valid
    points than samples the indices repeat."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    sel = torch.zeros((b, num_samples), dtype=torch.int64, device=points.device)
    sel[:, 0] = torch.argmax(mask.to(torch.int32), dim=1)
    dists = torch.where(mask, BIG, -BIG).to(torch.float32)
    for i in range(1, num_samples):
        last = points[rows, sel[:, i - 1]]
        dists = torch.minimum(dists, sq_dist(points, last[:, None]))
        sel[:, i] = torch.argmax(dists, dim=1)
    return sel.to(torch.int32)


def fps_key(dist, index):
    """FPS's key of points with running distances ``dist`` (f32) and
    indices ``index`` (< 2**FPS_IDX_BITS) in their scan: the kernel's u64
    key less 2**63, as int64, which keeps its order. The high 32 bits map
    the f32 to an unsigned int in its order (flip every bit of a negative,
    the sign bit of the rest), the low ones hold ``2**FPS_IDX_BITS - 1 -
    index`` above FPS_POS_BITS, where the kernel keeps the point's slot in
    its block (0 here: a scan's indices are unique, so the slot never
    decides). So the max of the keys is the argmax of the distances with
    the lowest index among equal ones. -0.0 orders below 0.0; a running
    distance is never -0.0 (the initial 1e9 and a sum of squares)."""
    bits = dist.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = torch.where(bits >= 2 ** 31, bits ^ 0xFFFFFFFF, bits | 2 ** 31)
    low = (2 ** FPS_IDX_BITS - 1 - torch.as_tensor(index).to(torch.int64)) << FPS_POS_BITS
    return ((hi - 2 ** 31) << 32) | low


def fps_key_index(key):
    """The index in its scan of the point a key (``fps_key``) holds."""
    return 2 ** FPS_IDX_BITS - 1 - ((key & 0xFFFFFFFF) >> FPS_POS_BITS)


def _spread3(v):
    """Every third bit of v's low 10 bits (Morton interleave), int64."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def fps_sort_keys(points, mask):
    """The FPS kernel's sort keys (``fps_keys_kernel``, in the same f32
    operations), (B, N) int64: the scan above FPS_CODE_BITS, then the Morton
    code of the point's cell in a FPS_CELLS**3 grid over the valid points'
    bounds (over all scans), cell ``floor((x - lo) * (FPS_CELLS / max(hi -
    lo, 1e-30)))`` clamped to the grid; an invalid point's code, 2**30, lies
    past every cell. The kernel sorts them stably, so points of one cell
    keep their index order."""
    b = points.shape[0]
    valid = mask[..., None]
    lo = torch.where(valid, points, float("inf")).amin(dim=(0, 1))
    hi = torch.where(valid, points, float("-inf")).amax(dim=(0, 1))
    scale = FPS_CELLS / torch.clamp(hi - lo, min=1e-30)
    u = torch.clamp(torch.floor((points - lo) * scale), 0, FPS_CELLS - 1).long()
    code = (_spread3(u[..., 0]) << 2) | (_spread3(u[..., 1]) << 1) | _spread3(u[..., 2])
    code = torch.where(mask, code, 2 ** 30)
    return (torch.arange(b, device=points.device)[:, None] << FPS_CODE_BITS) | code


def fps_boxes(points, valid):
    """Bounding boxes of groups of points: points (..., G, 3) f32 and their
    validity (..., G) -> lo, hi (..., 3) over the valid ones (+inf and -inf
    where none is)."""
    v = valid[..., None]
    return (torch.where(v, points, float("inf")).amin(dim=-2),
            torch.where(v, points, float("-inf")).amax(dim=-2))


def fps_lower_bound(lo, hi, s):
    """``sq_dist`` from s to the nearest point of the box [lo, hi] (the
    sample clamped to the box, then the same rounded operations): never
    above the f32 ``sq_dist`` from s to a point of the box (proof in
    ``farthest_point_sampling_buckets``); +inf for an empty box."""
    return sq_dist(torch.minimum(torch.maximum(s, lo), hi), s)


def farthest_point_sampling_buckets(points, mask, num_samples, group=24):
    """The FPS kernel's algorithm in plain PyTorch, equal to
    ``farthest_point_sampling_plain``: points in ``fps_sort_keys`` order, in
    groups of ``group`` consecutive ones (a kernel thread's), each with the
    bounding box of its valid points and its best key (``fps_key``). A step
    computes each group's ``fps_lower_bound`` to the last sample and updates
    only the groups whose bound is below their largest running distance;
    the others keep their distances and best; the sample is the max key.

    Why a skip changes nothing: let p lie in the box [lo, hi] and c be the
    sample s clamped to it. Along each axis, p - s and c - s have the same
    sign (or c - s = 0) and |p - s| >= |c - s| in real numbers, so their f32
    differences obey |fl(p - s)| >= |fl(c - s)|: rounding to nearest is
    monotone. Squares, then the two sums (all >= 0) are monotone too, so
    lb = sq_dist(c, s) <= sq_dist(p, s) as both are rounded. If lb >= the
    group's largest running distance d, every member's d' <= d <= lb <=
    sq_dist(p, s), so min(d', sq_dist(p, s)) = d'. Invalid members (at
    -1e9) never change; the box holds the valid ones only.

    Returns (B, num_samples) int32 indices and the share of group updates
    over the steps after the first (the work the kernel does)."""
    b, n, _ = points.shape
    dev = points.device
    order = torch.argsort(fps_sort_keys(points, mask), dim=1, stable=True)
    g = -(-n // group)
    pad = g * group - n
    p = torch.nn.functional.pad(torch.gather(points, 1, order[..., None].expand(-1, -1, 3)),
                                (0, 0, 0, pad)).view(b, g, group, 3)
    v = torch.nn.functional.pad(torch.gather(mask, 1, order), (0, pad)).view(b, g, group)
    present = torch.nn.functional.pad(torch.ones_like(mask), (0, pad)).view(b, g, group)
    index = torch.nn.functional.pad(order, (0, pad)).view(b, g, group)
    lo, hi = fps_boxes(p, v)
    dist = torch.where(v, BIG, -BIG).to(torch.float32)
    absent = torch.iinfo(torch.int64).min

    def best_of(d):
        return torch.where(present, fps_key(d, index), absent).amax(dim=-1)

    best = best_of(dist)  # step 0: the first valid point
    rows = torch.arange(b, device=dev)
    sel = torch.zeros((b, num_samples), dtype=torch.int64, device=dev)
    updates = 0
    for i in range(num_samples):
        sel[:, i] = fps_key_index(best.amax(dim=1))
        if i + 1 == num_samples:
            break
        s = points[rows, sel[:, i]][:, None, None]  # (B, 1, 1, 3)
        lb = fps_lower_bound(lo, hi, s[:, 0])  # (B, G)
        top = torch.where(present, dist, float("-inf")).amax(dim=-1)
        upd = lb < top
        dist = torch.where(upd[..., None], torch.minimum(dist, sq_dist(p, s)), dist)
        best = torch.where(upd, best_of(dist), best)
        updates += int(upd.sum())
    share = updates / max(1, b * g * (num_samples - 1))
    return sel.to(torch.int32), share


def fps_run(points, mask, num_samples, mode=0):
    """One launch of the FPS kernel's C entry (``toda_fps``) on CUDA
    tensors, not counted in LAUNCHES: the wrapper's call with mode 0; the
    others split its time for measurement (mode 1 skips the distance
    update, mode 2 runs empty steps)."""
    b, n, _ = points.shape
    lib = _lib()
    work = torch.empty(lib.toda_fps_workspace(b, n), dtype=torch.uint8, device=points.device)
    out = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    err = lib.toda_fps(points.data_ptr(), mask.data_ptr(), out.data_ptr(), work.data_ptr(),
                       work.numel(), b, n, num_samples, mode, _stream(points))
    _build.check(err, "farthest_point_sampling")
    return out


def farthest_point_sampling(points, mask, num_samples):
    """FPS of ``num_samples`` indices per scan (see the plain version). On
    the card one call sorts the points (bounds, Morton keys, a radix sort)
    and runs the FPS kernel, in one workspace.

    Args:
        points: (B, N, 3) float32, contiguous; N at most FPS_MAX_POINTS on
            the card.
        mask: (B, N) bool; invalid points are never taken while a valid
            point is left.
        num_samples: samples per scan.
    Returns (B, num_samples) int32 indices into N.
    """
    if points.device.type == "cpu":
        return farthest_point_sampling_plain(points, mask, num_samples)
    _check_xyz(points, "farthest_point_sampling: points")
    b, n, _ = points.shape
    _check_mask(mask, (b, n), points.device, "farthest_point_sampling: mask")
    if not 1 <= n <= FPS_MAX_POINTS or num_samples < 1 or b * n >= 2 ** 31:
        raise ValueError(f"farthest_point_sampling: N {n} not in 1..{FPS_MAX_POINTS}, "
                         f"num_samples {num_samples} < 1 or B * N >= 2**31")
    out = fps_run(points, mask, num_samples)
    LAUNCHES["farthest_point_sampling"] += 1
    return out


def ball_query_plain(radius, nsample, xyz, xyz_mask, new_xyz, new_mask, chunk=512):
    """Plain PyTorch ball query (JAX :48-66), batched: xyz (B, N, 3) +
    mask, new_xyz (B, M, 3) + mask -> idx (B, M, nsample) int32, cnt (B, M)
    int32. A point is in the ball when valid and ``d2 < float32(r**2)``;
    the slots hold the first nsample in-ball points in index order, and the
    slots past cnt repeat the first one (index 0 when there is none). The
    in-ball mask's running count (cumsum) and ``searchsorted`` for 1..nsample
    pick the same indices as JAX's argsort, in O(N) a query, over ``chunk``
    queries at a time."""
    b, m = new_xyz.shape[:2]
    r2 = radius_sq(radius)
    want = torch.arange(1, nsample + 1, dtype=torch.int32, device=xyz.device)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    for i in range(b):
        for s in range(0, m, chunk):
            q, qm = new_xyz[i, s:s + chunk], new_mask[i, s:s + chunk]
            inb = (sq_dist(q[:, None], xyz[i][None]) < r2) & xyz_mask[i][None] & qm[:, None]
            run = torch.cumsum(inb.to(torch.int32), dim=1)
            pos = torch.searchsorted(run, want.expand(len(q), nsample).contiguous())
            c = torch.clamp(run[:, -1], max=nsample)
            first = torch.where(c > 0, pos[:, 0], 0)
            slot = torch.arange(nsample, device=xyz.device)[None]
            idx[i, s:s + chunk] = torch.where(slot < c[:, None], pos, first[:, None]).to(torch.int32)
            cnt[i, s:s + chunk] = c
    return idx, cnt


def bq_side_min(radius):
    """The grid's least cell side, float32(radius * (1 + BQ_CELL_MARGIN))."""
    return float(np.float32(float(radius) * (1 + BQ_CELL_MARGIN)))


def bq_axis_cells(b):
    """The most cells along an axis for b scans: BQ_MAX_CELLS, or fewer so
    that b * cells**3 < 2**31 and every key fits 31 bits."""
    cap = min(BQ_MAX_CELLS, int((2 ** 31 / b) ** (1 / 3)) + 1)
    while b * cap ** 3 >= 2 ** 31:
        cap -= 1
    return cap


def ball_query_grid(radius, xyz, xyz_mask, new_xyz):
    """Plain PyTorch version of the ball-query kernel's binning (the CPU
    tests hold it to brute force; the kernels compute the same keys and
    ranges in the same f32 operations): the candidates ordered by (scan,
    cell), and each query's candidate ranges.

    The grid starts at the valid candidates' lower corner (over all scans;
    0 where none is valid). Its cell side along an axis is ``bq_side_min``,
    or the extent / (cap - 1) where that is larger, cap = ``bq_axis_cells(B)``.
    A cell index is ``floor((x - corner) / side)`` in f32, clamped to [-2,
    cells + 1], for candidates and queries alike. Keys run (scan, cy, cx,
    cz), so a column's three z-cells are one run of the order: a query has
    nine ranges, the columns (cy + dy, cx + dx) for dy, dx in (-1, 0, 1)
    over z-cells cz - 1 .. cz + 1, clamped to the grid (empty off it). An
    invalid candidate's key, B x cells, lies past every cell, in no range.
    The ranges of a query are disjoint.

    Why no in-ball point is missed: f32 rounds x - corner and its quotient
    by the side, so a cell position u is off its real value by at most
    2**-23 * u <= 2**-23 * BQ_MAX_CELLS = 2**-12. A point whose f32 d2 is
    below float32(r**2) lies within r * (1 + 3 * 2**-24) of the query
    along each axis, so the two positions differ by at most (1 + 3 *
    2**-24) / (1 + 2**-10) + 2 * 2**-12 < 1: their floors differ by at most
    1, and the point lies in one of the query's 27 cells.

    Args:
        radius: ball radius.
        xyz: (B, N, 3) float32 candidates; xyz_mask (B, N) bool.
        new_xyz: (B, M, 3) float32 queries.
    Returns order (B * N,) int64, the flat candidate indices (scan * N + i)
    sorted stably by key, and ranges (B, M, 9, 2) int32, each column's
    [start, end) in order.
    """
    b = xyz.shape[0]
    m = new_xyz.shape[1]
    dev = xyz.device
    valid = xyz_mask[..., None]
    lo = torch.where(valid, xyz, float("inf")).amin(dim=(0, 1))
    hi = torch.where(valid, xyz, float("-inf")).amax(dim=(0, 1))
    some = lo <= hi  # false where no candidate is valid
    ext = torch.where(some, hi - lo, 0.0)
    lo = torch.where(some, lo, 0.0)
    side = torch.clamp(ext / (bq_axis_cells(b) - 1), min=bq_side_min(radius))
    dims = torch.floor(ext / side).long() + 1  # cells along x, y, z

    def cells(p):
        u = torch.floor((p - lo) / side)
        return torch.minimum(torch.clamp(u, min=-2.0), (dims + 1).float()).long()

    nx, ny, nz = dims[0], dims[1], dims[2]
    scan = torch.arange(b, device=dev)
    c = cells(xyz)
    key = ((scan[:, None] * ny + c[..., 1]) * nx + c[..., 0]) * nz + c[..., 2]
    key = torch.where(xyz_mask, key, b * ny * nx * nz).to(torch.int32)
    skey, order = torch.sort(key.reshape(-1), stable=True)

    qc = cells(new_xyz)
    step = torch.arange(-1, 2, device=dev)
    cy = qc[..., 1, None, None] + step[:, None]  # (B, M, 3, 1)
    cx = qc[..., 0, None, None] + step  # (B, M, 1, 3)
    z0 = torch.clamp(qc[..., 2] - 1, min=0)[..., None, None]
    z1 = torch.minimum(qc[..., 2] + 1, nz - 1)[..., None, None]
    inside = (cy >= 0) & (cy < ny) & (cx >= 0) & (cx < nx) & (z0 <= z1)
    col = ((scan[:, None, None, None] * ny + cy) * nx + cx) * nz
    bounds = torch.stack([torch.where(inside, col + z0, 0), torch.where(inside, col + z1 + 1, 0)],
                         dim=-1)
    ranges = torch.searchsorted(skey, bounds.reshape(-1).to(torch.int32), out_int32=True)
    return order, ranges.view(b, m, 9, 2)


def ball_query(radius, nsample, xyz, xyz_mask, new_xyz, new_mask, chunk=512):
    """Up to ``nsample`` neighbours within ``radius`` of each query (see the
    plain version; ``chunk`` bounds only the plain version's memory). On
    the card one call bins the candidates (``ball_query_grid``'s grid, in
    kernels and a radix sort) and runs the grid kernel over each query's
    nine ranges, all in one workspace.

    Args:
        radius: ball radius (the test is d2 < float32(radius**2)).
        nsample: slots per query, at most BQ_MAX_NSAMPLE on the card.
        xyz: (B, N, 3) float32 candidates, contiguous; xyz_mask (B, N) bool.
        new_xyz: (B, M, 3) float32 queries, contiguous; new_mask (B, M) bool.
    Returns idx (B, M, nsample) int32 and cnt (B, M) int32.
    """
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, xyz_mask, new_xyz, new_mask, chunk)
    _check_xyz(xyz, "ball_query: xyz")
    b, n, _ = xyz.shape
    _check_xyz(new_xyz, "ball_query: new_xyz", b)
    m = new_xyz.shape[1]
    _check_mask(xyz_mask, (b, n), xyz.device, "ball_query: xyz_mask")
    _check_mask(new_mask, (b, m), xyz.device, "ball_query: new_mask")
    if not 1 <= nsample <= BQ_MAX_NSAMPLE or n < 1 or b * n >= 2**31:
        raise ValueError(f"ball_query: nsample {nsample} not in 1..{BQ_MAX_NSAMPLE}, or (B, N) "
                         f"{(b, n)} empty or too large")
    lib = _lib()
    work = torch.empty(lib.toda_ball_query_workspace(b, n), dtype=torch.uint8, device=xyz.device)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    err = lib.toda_ball_query(xyz.data_ptr(), xyz_mask.data_ptr(), new_xyz.data_ptr(),
                              new_mask.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                              work.data_ptr(), work.numel(), b, n, m, radius_sq(radius),
                              bq_side_min(radius), bq_axis_cells(b), nsample, _stream(xyz))
    _build.check(err, "ball_query")
    LAUNCHES["ball_query"] += 1
    return idx, cnt


def query_and_group(radius, nsample, xyz, xyz_mask, new_xyz, new_mask, features=None,
                    chunk=512):
    """Ball query + grouping (JAX :104-119), batched: grouped (B, M,
    nsample, 3 + C) rows ``[xyz - query, features]`` and the slot validity
    (B, M, nsample) (slot < cnt and the query valid); invalid slots are
    zero. features (B, N, C) or None."""
    idx, cnt = ball_query(radius, nsample, xyz, xyz_mask, new_xyz, new_mask, chunk)
    b, m = idx.shape[:2]
    flat = idx.reshape(b, m * nsample).long()

    def take(t):
        return torch.gather(t, 1, flat[..., None].expand(-1, -1, t.shape[-1])).view(
            b, m, nsample, t.shape[-1])

    grouped = take(xyz) - new_xyz[:, :, None]
    slot_valid = (torch.arange(nsample, device=idx.device)[None, None] < cnt[..., None]) \
        & new_mask[..., None]
    if features is not None:
        grouped = torch.cat([grouped, take(features)], dim=-1)
    return torch.where(slot_valid[..., None], grouped, torch.zeros((), device=grouped.device,
                                                                   dtype=grouped.dtype)), slot_valid
