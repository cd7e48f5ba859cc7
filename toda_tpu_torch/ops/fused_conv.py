"""Fused (affine + relu) -> 3x3x3 sparse pillar convolution, forward (kernel K1).

Counterpart of ``toda_tpu/ops/pallas_fused_conv.py`` ``fused_bnconv9_t``
(:1678, TPU kernel ``_fwd_kernel`` :475; plain reference ``_ref_fwd`` :1262)
in the port's row-major layout: activations are (M, nz, C) instead of the
TPU's transposed (nz*C, M). The CUDA kernel is in
``toda_tpu_torch/csrc/fused_conv.cu``; its header says what bounds it on the
H100 and why it is built as it is. The wrapper runs the plain PyTorch version
for a tensor on the CPU, launches the kernel for a CUDA tensor, and counts its
launches in ``fused_bnconv9.launches``.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_geometry = None


def _lib():
    global _geometry
    lib = _build.library("fused_conv.cu")
    if _geometry is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.toda_fused_bnconv9.argtypes = [p, p, p, p, p, p] + [i32] * 10 + [p]
        lib.toda_fused_bnconv9.restype = i32
        lib.toda_fused_bnconv9_geometry.argtypes = [p, p]
        lib.toda_fused_bnconv9_geometry.restype = i32
        threads, rows = ctypes.c_int(), ctypes.c_int()
        lib.toda_fused_bnconv9_geometry(ctypes.addressof(threads), ctypes.addressof(rows))
        _geometry = (threads.value, rows.value)
    return lib


def out_depth(nz_in, z_stride):
    return -(-nz_in // z_stride)


def fused_bnconv9_plain(x, scale, shift, weights, idx, z_stride=1, act=True):
    """Plain PyTorch K1, f32 arithmetic (see ``fused_bnconv9``)."""
    m_in, nz, c = x.shape
    m_out = idx.shape[0]
    nz_out = out_depth(nz, z_stride)
    a = x.float()
    if act:
        a = torch.relu(a * scale.float() + shift.float())
    a = a.to(x.dtype).float()
    # zero z halo and a zero row that the -1 (missing) taps gather
    halo = F.pad(a, (0, 0, 1, 1))
    halo = torch.cat([halo, halo.new_zeros((1,) + halo.shape[1:])])
    safe = torch.where(idx >= 0, idx.long(), m_in)
    w = weights.float()
    y = torch.zeros((m_out, nz_out, w.shape[-1]), dtype=torch.float32, device=x.device)
    zspan = z_stride * (nz_out - 1) + 1
    for t in range(9):
        g = halo[safe[:, t]]  # (m_out, nz+2, c)
        for dz in range(3):
            y += g[:, dz : dz + zspan : z_stride] @ w[dz, t // 3, t % 3]
    return y.to(x.dtype)


def fused_bnconv9(x, scale, shift, weights, idx, z_stride=1, act=True):
    """y = conv3x3x3(act(x)) over a sparse pillar set.

        y[m, zo, co] = sum_{t, dz, c} a(idx[m, t], s*zo + dz - 1, c)
                                      * weights[dz, t // 3, t % 3, c, co]

    a(j, z, c) is 0 where j == -1 or z is outside [0, nz_in) (missing
    neighbours and the z halo are zero after the activation), else
    ``relu(x[j, z, c] * scale[c] + shift[c])`` rounded to x's dtype when
    ``act``, else ``x[j, z, c]``. Sums are f32; y is rounded to x's dtype.

    Args:
        x: (M_in, nz_in, C) float32 or bfloat16, contiguous; C % 4 == 0.
        scale, shift: (C,) float32 (the pending BatchNorm affine).
        weights: (3, 3, 3, C, Cout) in (dz, dy, dx) order, x's dtype;
            Cout divides 256.
        idx: (M_out, 9) int32 neighbour table, tap t = dy*3 + dx, -1 missing.
        z_stride: 1 or 2; nz_out = ceil(nz_in / z_stride).
    Returns (M_out, nz_out, Cout) in x's dtype. Rows whose taps are all -1
    are zero.
    """
    if x.device.type == "cpu":
        return fused_bnconv9_plain(x, scale, shift, weights, idx, z_stride, act)
    m_in, nz_in, c = x.shape
    cout = weights.shape[-1]
    m_out = idx.shape[0]
    if not x.is_cuda or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"fused_bnconv9: x must be a contiguous f32/bf16 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    if weights.dtype != x.dtype or weights.shape != (3, 3, 3, c, cout) \
            or not weights.is_contiguous() or weights.device != x.device:
        raise ValueError(f"fused_bnconv9: weights must be contiguous (3, 3, 3, {c}, Cout) "
                         f"{x.dtype} on x's device, got {weights.dtype} {tuple(weights.shape)}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous() \
                or v.device != x.device:
            raise ValueError(f"fused_bnconv9: {name} must be a contiguous ({c},) f32 tensor "
                             "on x's device")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != 9 \
            or not idx.is_contiguous() or idx.device != x.device:
        raise ValueError("fused_bnconv9: idx must be a contiguous (M_out, 9) int32 tensor "
                         "on x's device")
    if z_stride not in (1, 2) or c % 4 != 0:
        raise ValueError(f"fused_bnconv9: needs z_stride in (1, 2) and C % 4 == 0, "
                         f"got {z_stride}, {c}")
    lib = _lib()
    threads, rows = _geometry
    if cout > threads or threads % cout != 0:
        raise ValueError(f"fused_bnconv9: Cout={cout} must divide {threads}")
    nz_out = out_depth(nz_in, z_stride)
    rows_cap = rows * (threads // cout)  # output rows (pillar, z) of one block
    zt = min(nz_out, rows_cap)
    tm = rows_cap // zt
    smem = 4 * (3 * c * cout + tm * (z_stride * (zt - 1) + 3) * c)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_bnconv9: C={c}, Cout={cout} needs {smem} bytes of "
                         "shared memory per block")
    y = torch.empty((m_out, nz_out, cout), dtype=x.dtype, device=x.device)
    err = lib.toda_fused_bnconv9(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weights.data_ptr(),
        idx.data_ptr(), y.data_ptr(), m_out, nz_in, nz_out, c, cout, z_stride,
        int(bool(act)), tm, zt, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_bnconv9")
    fused_bnconv9.launches += 1
    return y


fused_bnconv9.launches = 0
