"""Row scatter-add (kernel K4), the voxelizer unpack (kernel K5), the row
gather (kernel K6), the multi-tap row gather (kernel K9) and the column
gathers of the transposed layout (kernels K7 and K8).

Counterparts of ``toda_tpu/ops/pallas_gather.py``: ``scatter_rows_add``
(:1143, TPU kernel ``_scatter_kernel`` :925), ``unpack_pillars_t`` (:1251,
TPU kernel ``_unpack_kernel`` :1200), ``gather_rows`` (:1121, TPU kernel
``_gather_kernel`` :97), ``gather_rows_taps`` (:301, TPU kernel
``_gather_taps_kernel`` :201), ``gather_rows_taps_t`` (:479, TPU kernel
``_gather_taps_t_kernel`` :354) and ``gather9_stacked_t`` (:682, TPU kernel
``_gather9_stacked_kernel`` :514). The CUDA kernels are in
``toda_tpu_torch/csrc/gather.cu``; its header says what bounds each one on the
H100 and why it is built as it is. Each wrapper runs its plain PyTorch version
for a tensor on the CPU, launches its kernel for a CUDA tensor, and counts its
launches in ``LAUNCHES[<wrapper name>]``.
"""

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_bound = False
LAUNCHES = {"scatter_rows_add": 0, "unpack_pillars": 0, "gather_rows": 0,
            "gather_rows_taps": 0, "gather_rows_taps_t": 0, "gather9_stacked_t": 0}


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
        lib.toda_gather_rows_taps_t.argtypes = [p, p, p, i64, i64, i32, i32, i32, p]
        lib.toda_gather_rows_taps_t.restype = i32
        lib.toda_gather9_stacked_t.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, p]
        lib.toda_gather9_stacked_t.restype = i32
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


def scatter_rows_add(g, idx, n):
    """out[j] = sum of g[i] over the rows i with idx[i] == j, in f32.

    Args:
        g: (M, W) float32 or bfloat16, contiguous.
        idx: (M,) int32 in [-1, n); -1 rows are dropped. Rows with the same
            valid idx should be adjacent (the callers' indices are
            nondecreasing): each such run is summed in row order, so the
            result is then deterministic.
        n: output rows.
    Returns (n, W) float32.
    """
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



def unpack_pillars_plain(sums, c, cpad, dtype):
    """Plain PyTorch K5: (ncell, c+1) f32 [sums, count] -> (ncell, cpad) means."""
    cnt = torch.clamp(torch.round(sums[:, c]), min=1.0)
    out = torch.zeros((sums.shape[0], cpad), dtype=dtype, device=sums.device)
    out[:, :c] = (sums[:, :c] / cnt[:, None]).to(dtype)
    return out


def unpack_pillars(sums, c, cpad, dtype):
    """Per-cell mean features from the voxelizer's cell sums.

    Args:
        sums: (ncell, c+1) float32, contiguous: c feature sums, then the
            point count of each cell.
        c: features per point; cpad >= c: output channels (zeros past c).
        dtype: float32 or bfloat16 output.
    Returns (ncell, cpad) ``dtype(sum / max(round(count), 1))``.
    """
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
    (w, n), (m, ntap) = tableT.shape, idx.shape
    out = torch.empty((ntap, w, m), dtype=tableT.dtype, device=tableT.device)
    err = _lib().toda_gather_rows_taps_t(tableT.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                         n, m, ntap, w, tableT.element_size(), _stream(tableT))
    _build.check(err, "gather_rows_taps_t")
    LAUNCHES["gather_rows_taps_t"] += 1
    return out


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
    it = _stacked_identity(identity_tap, m, n)
    out = torch.empty((9 * w, m), dtype=tableT.dtype, device=tableT.device)
    err = _lib().toda_gather9_stacked_t(tableT.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m,
                                        w, tableT.element_size(), chunk or 0,
                                        -1 if it is None else it, _stream(tableT))
    _build.check(err, "gather9_stacked_t")
    LAUNCHES["gather9_stacked_t"] += 1
    return out
