"""Row scatter-add (kernel K4) and the voxelizer unpack (kernel K5).

Counterparts of ``toda_tpu/ops/pallas_gather.py``: ``scatter_rows_add``
(:1143, TPU kernel ``_scatter_kernel`` :925) and ``unpack_pillars_t`` (:1251,
TPU kernel ``_unpack_kernel`` :1200). The CUDA kernels are in
``toda_tpu_torch/csrc/gather.cu``; its header says what bounds each one on the
H100 and why it is built as it is. Each wrapper runs its plain PyTorch version
for a tensor on the CPU, launches its kernel for a CUDA tensor, and counts its
launches in ``<wrapper>.launches``.
"""

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_bound = False


def _lib():
    global _bound
    lib = _build.library("gather.cu")
    if not _bound:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.toda_scatter_rows_add.argtypes = [p, p, p, i64, i32, i32, p]
        lib.toda_scatter_rows_add.restype = i32
        lib.toda_unpack_pillars.argtypes = [p, p, i64, i32, i32, i32, p]
        lib.toda_unpack_pillars.restype = i32
        _bound = True
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
    scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0


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
    unpack_pillars.launches += 1
    return out


unpack_pillars.launches = 0
