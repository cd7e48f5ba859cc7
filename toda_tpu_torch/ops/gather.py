"""Row scatter-add (kernel K4), the voxelizer unpack (kernel K5), the row
gather (kernel K6) and the multi-tap row gather (kernel K9).

Counterparts of ``toda_tpu/ops/pallas_gather.py``: ``scatter_rows_add``
(:1143, TPU kernel ``_scatter_kernel`` :925), ``unpack_pillars_t`` (:1251,
TPU kernel ``_unpack_kernel`` :1200), ``gather_rows`` (:1121, TPU kernel
``_gather_kernel`` :97) and ``gather_rows_taps`` (:301, TPU kernel
``_gather_taps_kernel`` :201). The CUDA kernels are in
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
            "gather_rows_taps": 0}


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
