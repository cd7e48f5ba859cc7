"""Row scatter-add (kernel K4), the voxelizer unpack (kernel K5), the row
gather (kernel K6), the multi-tap row gather (kernel K9), the column
gathers of the transposed layout (kernels K7 and K8) and the fused column
gather + stride-1 conv (kernel K10).

Counterparts of ``toda_tpu/ops/pallas_gather.py``: ``scatter_rows_add``
(:1143, TPU kernel ``_scatter_kernel`` :925), ``unpack_pillars_t`` (:1251,
TPU kernel ``_unpack_kernel`` :1200), ``gather_rows`` (:1121, TPU kernel
``_gather_kernel`` :97), ``gather_rows_taps`` (:301, TPU kernel
``_gather_taps_kernel`` :201), ``gather_rows_taps_t`` (:479, TPU kernel
``_gather_taps_t_kernel`` :354), ``gather9_stacked_t`` (:682, TPU kernel
``_gather9_stacked_kernel`` :514) and ``gather9_conv_t`` (:856, TPU kernel
``_gather9_conv_kernel`` :729). The CUDA kernels are in
``toda_tpu_torch/csrc/gather.cu``; its header says what bounds each one on the
H100 and why it is built as it is. ``column_gather_rows`` sizes K7 / K8's row
slices and ``conv_t_plan`` chooses K10's launch. Each wrapper runs its plain
PyTorch version for a tensor on the CPU, launches its kernel for a CUDA
tensor, and counts its launches in ``LAUNCHES[<wrapper name>]``.
``scatter_rows_add`` and ``unpack_pillars`` are differentiable, so a
gradient with respect to the points reaches through the voxelizer: K4's
backward is K6 of the cotangent, K5's the VJP of its plain version.
"""

import ctypes

import torch

from . import _build
from ._plan import SMEM_LIMIT, plan_ints, row_stride, up

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_bound = False
LAUNCHES = {"scatter_rows_add": 0, "unpack_pillars": 0, "gather_rows": 0,
            "gather_rows_taps": 0, "gather_rows_taps_t": 0, "gather9_stacked_t": 0,
            "gather9_conv_t": 0}
# the column gathers (gather.cu gather_cols_kernel): a block takes 256
# output columns of one tap and a slice of table rows, loaded in batches of
# 16; a slice's table rows and the output its taps write should fit in L2
GATHER_COLS = 256
GATHER_BATCH_ROWS = 16
GATHER_SLICE_BYTES = 44 << 20
# K10 (gather.cu gather9_conv_kernel): 64 output columns a block, 8 a warp;
# a thread keeps 20 16x8 tiles of f32 sums (z cells x 16-channel tiles); the
# index tile is static shared memory
CONV_T_COLS = 64
CONV_T_ACC = 20
_CONV_T_STATIC = 9 * (CONV_T_COLS + 4) * 4 + 16
CONV_T_PLAN_FIELDS = ("nz", "c", "cout", "coutp", "kp", "zt", "rows", "grid_x", "grid_y", "smem")


def _lib():
    global _bound
    lib = _build.library("gather.cu")
    if not _bound:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.toda_scatter_rows_add.argtypes = [p, p, p, i64, i32, i32, p]
        lib.toda_scatter_rows_add.restype = i32
        lib.toda_unpack_pillars.argtypes = [p, p, i64, i32, i32, i32, p]
        lib.toda_unpack_pillars.restype = i32
        lib.toda_gather_rows.argtypes = [p, p, p, i64, i64, i32, p]
        lib.toda_gather_rows.restype = i32
        lib.toda_gather_rows_taps.argtypes = [p, p, p, i64, i32, i64, i32, p]
        lib.toda_gather_rows_taps.restype = i32
        lib.toda_gather_cols.argtypes = [p, p, p, i64, i64] + [i32] * 6 + [p]
        lib.toda_gather_cols.restype = i32
        lib.toda_gather9_conv_t.argtypes = [p, p, p, p, i64, i64,
                                            ctypes.POINTER(ctypes.c_int32), i32, i32, p]
        lib.toda_gather9_conv_t.restype = i32
        lib.toda_gather9_conv_plan_fields.restype = i32
        if lib.toda_gather9_conv_plan_fields() != len(CONV_T_PLAN_FIELDS):
            raise RuntimeError("gather.cu and CONV_T_PLAN_FIELDS disagree")
        _bound = True
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_table(table, what):
    if not table.is_cuda or table.dtype not in _DTYPE_CODE or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(f"{what}: table must be a contiguous 2-D f32/bf16 CUDA "
                         f"tensor, got {table.dtype} {tuple(table.shape)} on {table.device}")


def _word(row_bytes, *tensors):
    """The widest copy word (16, 4 or 2 bytes) that divides the row width and
    every tensor's address."""
    return next(w for w in (16, 4, 2)
                if row_bytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors))


def scatter_rows_add_plain(g, idx, n):
    """Plain PyTorch K4: f32 (n, W) sums of the rows of g by idx, -1 dropped."""
    safe = torch.where(idx >= 0, idx.long(), n)
    out = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, safe, g.float())
    return out[:n]


def _scatter_rows_add(g, idx, n):
    """K4 without autograd (see ``scatter_rows_add``)."""
    if g.device.type == "cpu":
        return scatter_rows_add_plain(g, idx, n)
    if not g.is_cuda or g.dtype not in _DTYPE_CODE or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"scatter_rows_add: g must be a contiguous 2-D f32/bf16 CUDA "
                         f"tensor, got {g.dtype} {tuple(g.shape)} on {g.device}")
    m, w = g.shape
    if idx.dtype != torch.int32 or idx.shape != (m,) or idx.device != g.device \
            or not idx.is_contiguous():
        raise ValueError("scatter_rows_add: idx must be a contiguous (M,) int32 "
                         "tensor on g's device")
    out = torch.zeros((n, w), dtype=torch.float32, device=g.device)
    err = _lib().toda_scatter_rows_add(g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                       m, w, _DTYPE_CODE[g.dtype], _stream(g))
    _build.check(err, "scatter_rows_add")
    LAUNCHES["scatter_rows_add"] += 1
    return out


class _ScatterRowsAdd(torch.autograd.Function):
    """K4 forward, its f32 sums rounded to ``out_dtype``; backward, its
    exact VJP: K6 (``gather_rows``) of the output cotangent by the same idx,
    a zero row where idx is -1, as JAX's gather / scatter pair
    (``pallas_gather.py:1104-1118``)."""

    @staticmethod
    def forward(ctx, g, idx, n, out_dtype):
        ctx.save_for_backward(idx)
        ctx.dtype = g.dtype
        return _scatter_rows_add(g, idx, n).to(out_dtype)

    @staticmethod
    def backward(ctx, gout):
        (idx,) = ctx.saved_tensors
        return gather_rows(gout.contiguous(), idx).to(ctx.dtype), None, None, None


def scatter_rows_add(g, idx, n, out_dtype=torch.float32):
    """out[j] = sum of g[i] over the rows i with idx[i] == j, in f32.

    Args:
        g: (M, W) float32 or bfloat16, contiguous.
        idx: (M,) int32 in [-1, n); -1 rows are dropped. Rows with the same
            valid idx should be adjacent (the callers' indices are
            nondecreasing): each such run is summed in row order, so the
            result is then deterministic.
        n: output rows.
        out_dtype: the sums are rounded to it (the voxelizer keeps f32, the
            dense scatter the rows' type).
    Returns (n, W) in ``out_dtype``. Differentiable in g: the backward is one
    K6 gather of the output cotangent.
    """
    return _ScatterRowsAdd.apply(g, idx, n, out_dtype)


def unpack_pillars_plain(sums, c, cpad, dtype):
    """Plain PyTorch K5: (ncell, c+1) f32 [sums, count] -> (ncell, cpad) means."""
    cnt = torch.clamp(torch.round(sums[:, c]), min=1.0)
    out = torch.zeros((sums.shape[0], cpad), dtype=dtype, device=sums.device)
    out[:, :c] = (sums[:, :c] / cnt[:, None]).to(dtype)
    return out


def _unpack_pillars(sums, c, cpad, dtype):
    """K5 without autograd (see ``unpack_pillars``)."""
    if sums.device.type == "cpu":
        return unpack_pillars_plain(sums, c, cpad, dtype)
    if not sums.is_cuda or sums.dtype != torch.float32 or sums.dim() != 2 \
            or sums.shape[1] != c + 1 or not sums.is_contiguous():
        raise ValueError(f"unpack_pillars: sums must be a contiguous (ncell, {c + 1}) "
                         f"f32 CUDA tensor, got {sums.dtype} {tuple(sums.shape)}")
    if dtype not in _DTYPE_CODE or cpad < c:
        raise ValueError(f"unpack_pillars: unsupported dtype {dtype} or cpad {cpad} < c {c}")
    ncell = sums.shape[0]
    out = torch.empty((ncell, cpad), dtype=dtype, device=sums.device)
    err = _lib().toda_unpack_pillars(sums.data_ptr(), out.data_ptr(), ncell, c, cpad,
                                     _DTYPE_CODE[dtype], _stream(sums))
    _build.check(err, "unpack_pillars")
    LAUNCHES["unpack_pillars"] += 1
    return out


class _UnpackPillars(torch.autograd.Function):
    """K5 forward; backward, the VJP of its plain version (no kernel, as in
    JAX, ``pallas_gather.py:1291-1296``): the feature sums get the output
    cotangent over the rounded count, the count column none."""

    @staticmethod
    def forward(ctx, sums, c, cpad, dtype):
        ctx.save_for_backward(sums)
        ctx.c = c
        return _unpack_pillars(sums, c, cpad, dtype)

    @staticmethod
    def backward(ctx, gy):
        (sums,) = ctx.saved_tensors
        c = ctx.c
        cnt = torch.clamp(torch.round(sums[:, c]), min=1.0)
        gs = torch.zeros_like(sums)
        gs[:, :c] = gy[:, :c].float() / cnt[:, None]
        return gs, None, None, None


def unpack_pillars(sums, c, cpad, dtype):
    """Per-cell mean features from the voxelizer's cell sums.

    Args:
        sums: (ncell, c+1) float32, contiguous: c feature sums, then the
            point count of each cell.
        c: features per point; cpad >= c: output channels (zeros past c).
        dtype: float32 or bfloat16 output.
    Returns (ncell, cpad) ``dtype(sum / max(round(count), 1))``.
    Differentiable in the sums.
    """
    return _UnpackPillars.apply(sums, c, cpad, dtype)



def gather_rows_plain(table, idx):
    """Plain PyTorch K6: out[i] = table[idx[i]], a zero row where idx is -1."""
    safe = torch.where(idx >= 0, idx.long(), 0)
    return torch.where((idx >= 0)[:, None], table[safe], torch.zeros((), dtype=table.dtype,
                                                                    device=table.device))


def gather_rows(table, idx):
    """out[i] = table[idx[i]], a zero row where idx[i] == -1.

    Args:
        table: (N, W) float32 or bfloat16, contiguous.
        idx: (M,) int32 in [-1, N).
    Returns (M, W) in table's dtype.
    """
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _check_table(table, "gather_rows")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != table.device \
            or not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be a contiguous (M,) int32 tensor on "
                         "table's device")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    row_bytes = table.shape[1] * table.element_size()
    err = _lib().toda_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                  idx.shape[0], row_bytes, _word(row_bytes, table, out),
                                  _stream(table))
    _build.check(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_rows_taps_plain(table, idx):
    """Plain PyTorch K9: out[t, i] = table[idx[i, t]], a zero row where -1."""
    safe = torch.where(idx >= 0, idx.long(), 0).t()
    return torch.where((idx >= 0).t()[..., None], table[safe],
                       torch.zeros((), dtype=table.dtype, device=table.device))


def gather_rows_taps(table, idx):
    """T row gathers from one table in one launch: out[t, i] = table[idx[i, t]],
    a zero row where idx[i, t] == -1.

    Args:
        table: (N, W) float32 or bfloat16, contiguous.
        idx: (M, T) int32 in [-1, N), T <= 9, contiguous.
    Returns (T, M, W) in table's dtype.
    """
    if table.device.type == "cpu":
        return gather_rows_taps_plain(table, idx)
    _check_table(table, "gather_rows_taps")
    if idx.dtype != torch.int32 or idx.dim() != 2 or not 1 <= idx.shape[1] <= 9 \
            or idx.device != table.device or not idx.is_contiguous():
        raise ValueError("gather_rows_taps: idx must be a contiguous (M, T <= 9) int32 "
                         "tensor on table's device")
    m, ntap = idx.shape
    out = torch.empty((ntap, m, table.shape[1]), dtype=table.dtype, device=table.device)
    row_bytes = table.shape[1] * table.element_size()
    err = _lib().toda_gather_rows_taps(table.data_ptr(), idx.data_ptr(), out.data_ptr(), m,
                                       ntap, row_bytes, _word(row_bytes, table, out),
                                       _stream(table))
    _build.check(err, "gather_rows_taps")
    LAUNCHES["gather_rows_taps"] += 1
    return out


def _check_idx(idx, table, ntaps, what):
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] not in ntaps \
            or idx.device != table.device or not idx.is_contiguous():
        raise ValueError(f"{what}: idx must be a contiguous (M, T) int32 tensor on table's "
                         f"device with T in {tuple(ntaps)}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def gather_rows_taps_t_plain(tableT, idx):
    """Plain PyTorch K8: out[t, :, m] = tableT[:, idx[m, t]], a zero column
    where -1."""
    safe = torch.where(idx >= 0, idx.long(), 0).t()  # (T, M)
    g = tableT.index_select(1, safe.reshape(-1)).view(tableT.shape[0], *safe.shape)
    return torch.where((idx >= 0).t()[:, None, :], g.transpose(0, 1),
                       torch.zeros((), dtype=tableT.dtype, device=tableT.device)).contiguous()


def gather_rows_taps_t(tableT, idx):
    """T column gathers from one table in one launch: out[t, w, m] =
    tableT[w, idx[m, t]], zero where idx[m, t] == -1.

    Args:
        tableT: (W, N) float32 or bfloat16, contiguous (one column per row
            of the folded pillar set).
        idx: (M, T) int32 in [-1, N), T <= 9, contiguous.
    Returns (T, W, M) in tableT's dtype.
    """
    if tableT.device.type == "cpu":
        return gather_rows_taps_t_plain(tableT, idx)
    _check_table(tableT, "gather_rows_taps_t")
    _check_idx(idx, tableT, range(1, 10), "gather_rows_taps_t")
    w, (m, ntap) = tableT.shape[0], idx.shape
    out = torch.empty((ntap, w, m), dtype=tableT.dtype, device=tableT.device)
    _gather_cols(tableT, idx, out, 0, None, "gather_rows_taps_t")
    return out


def column_gather_rows(n, m, ntap, esize):
    """Table rows one K7 / K8 block takes: 32 or 16, the most that keep a
    slice's table rows and the output its taps write (rows x (N + T*M)
    elements of ``esize`` bytes) within ``GATHER_SLICE_BYTES``. A slice's
    taps run one after another and read its rows from L2; a taller slice
    spreads a block's fixed latency (its index load and first gathers) over
    more rows. A third batch of 16 rows does not pay: 64-row slices were
    slower than 32-row ones on every recorded SECOND call that fits them."""
    rows = 2 * GATHER_BATCH_ROWS
    while rows > GATHER_BATCH_ROWS and rows * (n + ntap * m) * esize > GATHER_SLICE_BYTES:
        rows //= 2
    return rows


def _gather_cols(tableT, idx, out, chunk, identity, what):
    """Launch the column-gather kernel (K7, K8) into ``out``."""
    (w, n), (m, ntap) = tableT.shape, idx.shape
    if n >= 1 << 27:
        raise ValueError(f"{what}: tables of N >= 2^27 columns are not taken, got N = {n}")
    err = _lib().toda_gather_cols(tableT.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m, ntap,
                                  w, tableT.element_size(), chunk or 0,
                                  -1 if identity is None else identity,
                                  column_gather_rows(n, m, ntap, tableT.element_size()),
                                  _stream(tableT))
    _build.check(err, what)
    LAUNCHES[what] += 1


def _stacked_identity(identity_tap, m, n):
    """The tap K7 copies from the table's own column: ``identity_tap`` when
    the output columns are the table's (M == N), else None."""
    return identity_tap if identity_tap is not None and m == n else None


def gather9_stacked_t_plain(tableT, idx, chunk=None, identity_tap=None):
    """Plain PyTorch K7 (the TPU kernel's output, identity copy included)."""
    w, n = tableT.shape
    m = idx.shape[0]
    g = gather_rows_taps_t_plain(tableT, idx)  # (9, W, M)
    it = _stacked_identity(identity_tap, m, n)
    if it is not None:
        g[it] = tableT
    if chunk is None:
        return g.reshape(9 * w, m)
    return g.view(9, w // chunk, chunk, m).transpose(0, 1).reshape(9 * w, m)


def gather9_stacked_t(tableT, idx, chunk=None, identity_tap=None):
    """All nine taps' column gathers stacked in one (9W, M) tensor.

    Args:
        tableT: (W, N) float32 or bfloat16, contiguous.
        idx: (M, 9) int32 in [-1, N), contiguous; -1 gives a zero column.
        chunk: None for the row order [t][W] (row t*W + w is tap t of table
            row w); else a divisor of W, for [W / chunk][t][chunk] (row
            j*9*chunk + t*chunk + r is tap t of table row j*chunk + r).
        identity_tap: when M == N, the tap whose columns are copied from the
            table's own columns (column m of tap t is tableT[:, m]) instead of
            gathered, whatever idx holds there, as the TPU kernel does.
    Returns (9W, M) in tableT's dtype.
    """
    if tableT.device.type == "cpu":
        return gather9_stacked_t_plain(tableT, idx, chunk, identity_tap)
    _check_table(tableT, "gather9_stacked_t")
    _check_idx(idx, tableT, (9,), "gather9_stacked_t")
    w, n = tableT.shape
    m = idx.shape[0]
    if chunk is not None and (chunk <= 0 or w % chunk):
        raise ValueError(f"gather9_stacked_t: chunk {chunk} must divide W = {w}")
    out = torch.empty((9 * w, m), dtype=tableT.dtype, device=tableT.device)
    _gather_cols(tableT, idx, out, chunk, _stacked_identity(identity_tap, m, n),
                 "gather9_stacked_t")
    return out


def gather9_conv_t_plain(tableT, idx, weights, nz, identity_tap=None):
    """Plain PyTorch K10: K7's plain gather, then the z product of
    ``pillar_conv3d_t``'s forward in f32, rounded once to the table's type."""
    from .pillar_sparse import _taps_weights, _zconv_t

    w, m = tableT.shape[0], idx.shape[0]
    c = w // (nz + 2)
    g = gather9_stacked_t_plain(tableT, idx, identity_tap=identity_tap).view(9, w, m)
    acc = _zconv_t(g.float(), _taps_weights(weights.float()), c, 1)
    return acc.to(tableT.dtype).reshape(-1, m)


def conv_t_plan(c, cout, nz, esize, m):
    """The launch of K10 on a haloed ((nz+2)*C, N) table of ``esize``-byte
    elements, Cout output channels and M output columns: a dict of
    ``CONV_T_PLAN_FIELDS`` (gather.cu ``ConvTPlan``).

    A block owns ``CONV_T_COLS`` output columns and ``zt`` output z cells
    (``grid_x`` x ``grid_y`` blocks); each of its 8 warps sums 8 columns for
    all ``coutp`` channels (Cout rounded up to 16) and all zt z cells, so zt
    is at most ``CONV_T_ACC`` / (coutp / 16). A tap stages ``rows`` =
    (zt+2)*C + kp - 3C table rows (kp: 3C rounded up to 16, the products'
    depth; the rows past the z halo are what the last z cell's padded depth
    reads). The z cells are cut into the fewest even tiles, then narrowed
    until the shared memory (two taps' weights, then the staged tap or the
    output tile) fits. Raises ValueError for a shape the kernel does not
    take."""
    if c % 8 or cout not in (8, 16, 32, 64) or nz < 1:
        raise ValueError(f"gather9_conv_t: needs C % 8 == 0, Cout in (8, 16, 32, 64) and "
                         f"nz >= 1; got C {c}, Cout {cout}, nz {nz}")
    coutp, kp = max(cout, 16), up(3 * c, 16)
    wbytes = coutp * row_stride(kp * esize // 16) * 16
    tiles = -(-nz // (CONV_T_ACC // (coutp // 16)))
    for zt in range(-(-nz // tiles), 0, -1):
        rows = (zt + 2) * c + kp - 3 * c
        smem = 2 * wbytes + max(rows * CONV_T_COLS * esize,
                                zt * cout * (CONV_T_COLS * esize + 16))
        if smem <= SMEM_LIMIT - _CONV_T_STATIC:
            return dict(nz=nz, c=c, cout=cout, coutp=coutp, kp=kp, zt=zt, rows=rows,
                        grid_x=-(-m // CONV_T_COLS), grid_y=-(-nz // zt), smem=smem)
    raise ValueError(f"gather9_conv_t: C={c}, Cout={cout} does not fit in shared memory")


def pack_conv_t_weights(weights, plan):
    """K10's weights, packed once per call: (9, coutp, kp) in the weights'
    type, [t][co][dz*C + ci] = weights[dz, t // 3, t % 3, ci, co], zero past
    Cout and 3C."""
    c, cout = weights.shape[3:]
    packed = weights.new_zeros((9, plan["coutp"], plan["kp"]))
    packed[:, :cout, :3 * c] = weights.permute(1, 2, 4, 0, 3).reshape(9, cout, 3 * c)
    return packed


def gather9_conv_t(tableT, idx, weights, nz, identity_tap=None):
    """Fused 9-tap column gather + 3x3x3 z-stride-1 conv, transposed layout:

        out[zo*Cout + co, m] = sum_{t, dz, ci} weights[dz, t // 3, t % 3, ci, co]
                               * tableT[(zo + dz)*C + ci, src(m, t)]

    src(m, t) = idx[m, t], a zero column where -1; with ``identity_tap`` and
    M == N, that tap reads column m itself, as the TPU kernel does. Sums
    are f32; the output is rounded to the table's type once.

    Args:
        tableT: (W, N) float32 or bfloat16, contiguous, W = (nz+2)*C: the
            activations with one zero z cell of C rows on each side.
        idx: (M, 9) int32 in [-1, N), contiguous.
        weights: (3, 3, 3, C, Cout) in (dz, dy, dx) order, the table's type;
            C % 8 == 0 and Cout in {8, 16, 32, 64} (``conv_t_plan``).
        nz: output z cells (the input's, stride 1).
    Returns (nz*Cout, M) in the table's type, unmasked.
    """
    if tableT.device.type == "cpu":
        return gather9_conv_t_plain(tableT, idx, weights, nz, identity_tap)
    _check_table(tableT, "gather9_conv_t")
    _check_idx(idx, tableT, (9,), "gather9_conv_t")
    w, n = tableT.shape
    m = idx.shape[0]
    c, cout = w // (nz + 2), weights.shape[-1]
    if nz < 1 or w != (nz + 2) * c or weights.shape != (3, 3, 3, c, cout) \
            or weights.dtype != tableT.dtype or weights.device != tableT.device:
        raise ValueError(f"gather9_conv_t: needs W = (nz+2)*C and weights (3, 3, 3, C, Cout) "
                         f"in the table's type; got W {w}, nz {nz}, weights {weights.dtype} "
                         f"{tuple(weights.shape)}")
    plan = conv_t_plan(c, cout, nz, tableT.element_size(), m)
    it = _stacked_identity(identity_tap, m, n)
    packed = pack_conv_t_weights(weights, plan)
    out = torch.empty((nz * cout, m), dtype=tableT.dtype, device=tableT.device)
    err = _lib().toda_gather9_conv_t(tableT.data_ptr(), idx.data_ptr(), packed.data_ptr(),
                                     out.data_ptr(), n, m, plan_ints(plan, CONV_T_PLAN_FIELDS),
                                     -1 if it is None else it,
                                     _DTYPE_CODE[tableT.dtype], _stream(tableT))
    _build.check(err, "gather9_conv_t")
    LAUNCHES["gather9_conv_t"] += 1
    return out
