"""Fused (affine + relu) -> 3x3x3 sparse pillar convolution: forward (kernel
K1) and backward (kernel K2, and K3 through the dW kernel with act=False).

Counterpart of ``toda_tpu/ops/pallas_fused_conv.py`` ``fused_bnconv9_t``
(:1678, TPU kernels ``_fwd_kernel`` :475, ``_bwd_kernel`` :934 and
``_dw_kernel`` :736; plain reference ``_ref_fwd`` :1262) in the port's
row-major layout: activations are (M, nz, C) instead of the TPU's transposed
(nz*C, M). The CUDA kernels are in ``toda_tpu_torch/csrc/fused_conv.cu`` and
``fused_conv_bwd.cu``; their headers say what bounds them on the H100 and why
they are built as they are. Each wrapper runs its plain PyTorch version for a
tensor on the CPU, launches its kernel for a CUDA tensor, and counts its
launches in ``LAUNCHES[<wrapper name>]``. ``fused_bnconv9_ad`` is the
differentiable op: K1 forward, the dx and dW kernels backward.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_geometry = None
_bwd_geometry = None
DW_TILES = 132  # fixed row tiles of the dW kernel (one per H100 SM)
# kernel launches per wrapper; "fused_bnconv9_dw_raw" counts the dW launches
# with act=False (K3's function: a raw-input layer)
LAUNCHES = {"fused_bnconv9": 0, "fused_bnconv9_bwd_dx": 0, "fused_bnconv9_dw": 0,
            "fused_bnconv9_dw_raw": 0}


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


def _activated(x, scale, shift, act):
    """The forward's gathered activation as f32: relu(x*scale + shift)
    rounded to x's dtype when act, else x."""
    a = x.float()
    if act:
        a = torch.relu(a * scale.float() + shift.float())
    return a.to(x.dtype).float()


def fused_bnconv9_plain(x, scale, shift, weights, idx, z_stride=1, act=True):
    """Plain PyTorch K1, f32 arithmetic (see ``fused_bnconv9``)."""
    m_in, nz, c = x.shape
    m_out = idx.shape[0]
    nz_out = out_depth(nz, z_stride)
    # zero z halo and a zero row that the -1 (missing) taps gather
    halo = F.pad(_activated(x, scale, shift, act), (0, 0, 1, 1))
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
    _check_conv_args("fused_bnconv9", x, scale, shift, weights, idx, z_stride)
    m_in, nz_in, c = x.shape
    cout = weights.shape[-1]
    m_out = idx.shape[0]
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
    LAUNCHES["fused_bnconv9"] += 1
    return y


def _bwd_lib():
    global _bwd_geometry
    lib = _build.library("fused_conv_bwd.cu")
    if _bwd_geometry is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.toda_bnconv9_bwd_dx.argtypes = [p] * 9 + [i32] * 10 + [p]
        lib.toda_bnconv9_bwd_dx.restype = i32
        lib.toda_bnconv9_dw.argtypes = [p] * 7 + [i32] * 11 + [p]
        lib.toda_bnconv9_dw.restype = i32
        lib.toda_bnconv9_bwd_geometry.argtypes = [p, p, p]
        lib.toda_bnconv9_bwd_geometry.restype = i32
        vals = [ctypes.c_int() for _ in range(3)]
        lib.toda_bnconv9_bwd_geometry(*(ctypes.addressof(v) for v in vals))
        _bwd_geometry = tuple(v.value for v in vals)
    return lib


def fused_bnconv9_bwd_plain(x, scale, shift, weights, invf, gy, z_stride=1, act=True):
    """Plain PyTorch dx part of K2, f32 arithmetic: the exact VJP of
    ``fused_bnconv9_plain`` in x, scale and shift (see ``fused_bnconv9_bwd_dx``).
    Returns (dx in x's dtype, dscale f32, dshift f32)."""
    m_in, nz_in, c = x.shape
    m_out, nz_out, cout = gy.shape
    w = weights.float()
    # gy on the upsampled z' axis with a one-row halo: gu[:, u] holds
    # gy[:, (u-1)/s] where s divides u-1, else 0; plus a zero row for -1
    gu = torch.zeros((m_out + 1, nz_in + 2, cout), dtype=torch.float32, device=x.device)
    gu[:m_out, 1:1 + z_stride * (nz_out - 1) + 1:z_stride] = gy.float()
    safe = torch.where(invf >= 0, invf.long(), m_out)
    h = torch.zeros((m_in, nz_in, c), dtype=torch.float32, device=x.device)
    for t in range(9):
        g = gu[safe[:, t]]
        for dz in range(3):  # z' = z + 1 - dz, i.e. u = z + 2 - dz
            h += g[:, 2 - dz:2 - dz + nz_in] @ w[dz, t // 3, t % 3].T
    if not act:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return h.to(x.dtype), zeros, zeros.clone()
    xf = x.float()
    pre = (xf * scale.float() + shift.float()).to(x.dtype).float()
    g = torch.where(pre > 0, h, torch.zeros((), device=x.device))
    return (g * scale.float()).to(x.dtype), (g * xf).sum((0, 1)), g.sum((0, 1))


def fused_bnconv9_bwd_dx(x, scale, shift, weights, invf, gy, z_stride=1, act=True):
    """The input cotangents of ``fused_bnconv9`` (K2's dx part):

        h[j, z, c] = sum_{t, dz, zo: s*zo + dz - 1 == z} sum_co
                     gy[invf[j, t], zo, co] * weights[dz, t // 3, t % 3, c, co]

    then g = h where x*scale + shift (rounded to x's dtype) > 0 when ``act``,
    else h; dx = g * scale (act) or g, rounded to x's dtype; dscale =
    sum(g * x) and dshift = sum(g) over rows and z, in f32 (zeros when not
    act).

    Args:
        x: (M_in, nz_in, C) the forward's input; scale, shift (C,) f32;
            weights (3, 3, 3, C, Cout) in x's dtype: as ``fused_bnconv9``.
        invf: (M_in, 9) int32 inverse table: column t holds the output row m
            with idx[m, t] == j, -1 where there is none.
        gy: (M_out, nz_out, Cout) in x's dtype, contiguous.
    Returns (dx, dscale, dshift).
    """
    if x.device.type == "cpu":
        return fused_bnconv9_bwd_plain(x, scale, shift, weights, invf, gy, z_stride, act)
    m_in, nz_in, c = x.shape
    cout = weights.shape[-1]
    _check_conv_args("fused_bnconv9_bwd_dx", x, scale, shift, weights, invf, z_stride)
    nz_out = out_depth(nz_in, z_stride)
    if gy.dtype != x.dtype or gy.shape != (gy.shape[0], nz_out, cout) \
            or not gy.is_contiguous() or gy.device != x.device:
        raise ValueError(f"fused_bnconv9_bwd_dx: gy must be a contiguous (M_out, {nz_out}, "
                         f"{cout}) {x.dtype} tensor on x's device")
    if invf.shape[0] != m_in:
        raise ValueError("fused_bnconv9_bwd_dx: invf must have one row per input row")
    lib = _bwd_lib()
    threads, rows, _ = _bwd_geometry
    if c > threads or threads % c != 0 or cout % 4 != 0:
        raise ValueError(f"fused_bnconv9_bwd_dx: C={c} must divide {threads} and "
                         f"Cout={cout} be a multiple of 4")
    rows_cap = rows * (threads // c)  # input rows (pillar, z) of one block
    zt = min(nz_in, rows_cap)
    tm = rows_cap // zt
    smem = max(4 * (3 * c * cout + tm * (zt + 2) * cout), 8 * threads)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_bnconv9_bwd_dx: C={c}, Cout={cout} needs {smem} bytes "
                         "of shared memory per block")
    blocks = -(-m_in // tm) * -(-nz_in // zt)
    dx = torch.empty_like(x)
    part = torch.empty((2, blocks, c), dtype=torch.float32, device=x.device)
    err = lib.toda_bnconv9_bwd_dx(
        gy.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weights.data_ptr(),
        invf.data_ptr(), dx.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), m_in, nz_in,
        nz_out, c, cout, z_stride, int(bool(act)), tm, zt, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_bnconv9_bwd_dx")
    LAUNCHES["fused_bnconv9_bwd_dx"] += 1
    if not act:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    sums = part.sum(1)  # the per-block channel sums, added in a fixed order
    return dx, sums[0], sums[1]


def fused_bnconv9_dw_plain(x, scale, shift, idx, gy, z_stride=1, act=True):
    """Plain PyTorch dW of K2 / K3, f32: the exact VJP of
    ``fused_bnconv9_plain`` in the weights (see ``fused_bnconv9_dw``)."""
    m_in, nz, c = x.shape
    m_out, nz_out, cout = gy.shape
    halo = F.pad(_activated(x, scale, shift, act), (0, 0, 1, 1))
    halo = torch.cat([halo, halo.new_zeros((1,) + halo.shape[1:])])
    safe = torch.where(idx >= 0, idx.long(), m_in)
    g2 = gy.float().reshape(-1, cout)
    dw = torch.empty((3, 3, 3, c, cout), dtype=torch.float32, device=x.device)
    zspan = z_stride * (nz_out - 1) + 1
    for t in range(9):
        g = halo[safe[:, t]]
        for dz in range(3):
            a = g[:, dz:dz + zspan:z_stride].reshape(-1, c)
            dw[dz, t // 3, t % 3] = a.T @ g2
    return dw


def fused_bnconv9_dw(x, scale, shift, idx, gy, z_stride=1, act=True):
    """The weight cotangent of ``fused_bnconv9`` (K2's dW part; with
    act=False, K3):

        dW[dz, dy, dx, c, co] = sum_{m, zo} a(idx[m, t], s*zo + dz - 1, c)
                                            * gy[m, zo, co],  t = dy*3 + dx

    with a() the forward's activation (zero for missing taps and the z halo),
    summed in f32 in a fixed order: two calls give bit-identical results.

    Args: x, scale, shift, idx, z_stride, act as ``fused_bnconv9``; gy
        (M_out, nz_out, Cout) in x's dtype, contiguous; C and Cout multiples
        of 4 with C*Cout/16 dividing 256.
    Returns (3, 3, 3, C, Cout) f32.
    """
    if x.device.type == "cpu":
        return fused_bnconv9_dw_plain(x, scale, shift, idx, gy, z_stride, act)
    m_in, nz_in, c = x.shape
    m_out, nz_out, cout = gy.shape
    _check_conv_args("fused_bnconv9_dw", x, scale, shift, None, idx, z_stride)
    if gy.dtype != x.dtype or nz_out != out_depth(nz_in, z_stride) \
            or m_out != idx.shape[0] or not gy.is_contiguous() or gy.device != x.device:
        raise ValueError(f"fused_bnconv9_dw: gy must be a contiguous ({idx.shape[0]}, "
                         f"{out_depth(nz_in, z_stride)}, Cout) {x.dtype} tensor on x's device")
    lib = _bwd_lib()
    threads, _, chunk_rows = _bwd_geometry
    ntile = (c // 4) * (cout // 4)
    if cout % 4 != 0 or ntile == 0 or threads % ntile != 0:
        raise ValueError(f"fused_bnconv9_dw: C={c}, Cout={cout}: C*Cout/16 must divide "
                         f"{threads}")
    zt = min(nz_out, chunk_rows)
    tm = max(chunk_rows // zt, 1)
    smem = 4 * (tm * (z_stride * (zt - 1) + 3) * c + tm * zt * cout + 16 * threads)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_bnconv9_dw: C={c}, Cout={cout} needs {smem} bytes of "
                         "shared memory per block")
    chunks = -(-m_out // tm) * -(-nz_out // zt)
    tiles = max(1, min(DW_TILES, chunks))
    part = torch.empty((tiles, 27, c, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, c, cout), dtype=torch.float32, device=x.device)
    err = lib.toda_bnconv9_dw(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), idx.data_ptr(), gy.data_ptr(),
        part.data_ptr(), dw.data_ptr(), m_out, nz_in, nz_out, c, cout, z_stride,
        int(bool(act)), tm, zt, tiles, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_bnconv9_dw")
    LAUNCHES["fused_bnconv9_dw"] += 1
    if not act:
        LAUNCHES["fused_bnconv9_dw_raw"] += 1
    return dw


def _check_conv_args(name, x, scale, shift, weights, table, z_stride):
    """The argument checks K1 and its backward kernels share."""
    c = x.shape[-1]
    if not x.is_cuda or x.dtype not in _DTYPE_CODE or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (M, nz, C) f32/bf16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if weights is not None and (weights.dtype != x.dtype or weights.shape[:4] != (3, 3, 3, c)
                                or weights.dim() != 5 or not weights.is_contiguous()
                                or weights.device != x.device):
        raise ValueError(f"{name}: weights must be contiguous (3, 3, 3, {c}, Cout) "
                         f"{x.dtype} on x's device, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    for vname, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous() \
                or v.device != x.device:
            raise ValueError(f"{name}: {vname} must be a contiguous ({c},) f32 tensor "
                             "on x's device")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != 9 \
            or not table.is_contiguous() or table.device != x.device:
        raise ValueError(f"{name}: the tap table must be a contiguous (M, 9) int32 tensor "
                         "on x's device")
    if z_stride not in (1, 2) or c % 4 != 0:
        raise ValueError(f"{name}: needs z_stride in (1, 2) and C % 4 == 0, "
                         f"got {z_stride}, {c}")


class _FusedBnConv9(torch.autograd.Function):
    """K1 forward; backward: the dx kernel (skipped when x, scale and shift
    need no gradient) and the dW kernel (``_fused_vjp_bwd`` :1526)."""

    @staticmethod
    def forward(ctx, x, scale, shift, weights, idx, invf, z_stride, act):
        ctx.save_for_backward(x, scale, shift, weights, idx, invf)
        ctx.z_stride, ctx.act = z_stride, act
        return fused_bnconv9(x, scale, shift, weights, idx, z_stride, act)

    @staticmethod
    def backward(ctx, gy):
        x, scale, shift, weights, idx, invf = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        dx = dscale = dshift = dw = None
        if any(ctx.needs_input_grad[:3]):
            if invf is None:
                raise ValueError("fused_bnconv9_ad: the input gradient needs invf")
            dx, dscale, dshift = fused_bnconv9_bwd_dx(x, scale, shift, weights, invf, gy,
                                                      ctx.z_stride, ctx.act)
            dx = dx if ctx.needs_input_grad[0] else None
        if ctx.needs_input_grad[3]:
            # the weights reach the kernel in x's dtype, so dW rounds to it
            dw = fused_bnconv9_dw(x, scale, shift, idx, gy, ctx.z_stride,
                                  ctx.act).to(weights.dtype)
        return dx, dscale, dshift, dw, None, None, None, None


def fused_bnconv9_ad(x, scale, shift, weights, idx, invf=None, z_stride=1, act=True):
    """Differentiable ``fused_bnconv9`` in x, scale, shift and weights.
    ``invf`` (the inverse tap table, see ``fused_bnconv9_bwd_dx``) is needed
    only when x, scale or shift need a gradient."""
    return _FusedBnConv9.apply(x, scale, shift, weights, idx, invf, z_stride, act)
