"""Fused (affine + relu) -> 3x3x3 sparse pillar convolution: forward (kernel
K1) and backward (kernel K2, and K3 through the dW kernel with act=False).

Counterpart of ``toda_tpu/ops/pallas_fused_conv.py`` ``fused_bnconv9_t``
(:1678, TPU kernels ``_fwd_kernel`` :475, ``_bwd_kernel`` :934 and
``_dw_kernel`` :736; plain reference ``_ref_fwd`` :1262) in the port's
row-major layout: activations are (M, nz, C) instead of the TPU's transposed
(nz*C, M). The CUDA kernels are in ``toda_tpu_torch/csrc/fused_conv.cu`` and
``fused_conv_bwd.cu`` (K1 and dx share the gather-GEMM core of
``gather_gemm.cuh``); their headers say what bounds them on the H100 and why
they are built as they are. ``conv_plan`` and ``dw_plan`` choose each launch's
tiling and shared memory, ``tap_lists`` builds the dW kernel's per-tap lists
of present rows on the device. Each wrapper runs its plain PyTorch version
for a tensor on the CPU, launches its kernel for a CUDA tensor, and counts
its launches in ``LAUNCHES[<wrapper name>]``. ``fused_bnconv9_ad`` is the
differentiable op: K1 forward, the dx and dW kernels backward.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._plan import SMEM_LIMIT, plan_ints, pow2, row_stride, up

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_PER_SM = 233472  # bytes an H100 SM shares among its resident blocks
_SMEM_PER_BLOCK = 1024  # bytes the runtime reserves per resident block
WARPS = 8  # warps of every fused-conv block (gather_gemm.cuh kWarps)
_WEIGHT_BYTES = 110592  # the most a block's staged weights take: 9 taps x 3C x N
H100_SMS = 132
# the integer plans the kernels take (gather_gemm.cuh launch_planned,
# fused_conv_bwd.cu toda_bnconv9_dw), in this order
PLAN_FIELDS = ("m_dst", "n_src", "width", "n_out", "n_total", "c", "cout", "place", "astride",
               "kpad", "n_blk", "buf_rows", "stages", "act", "mt", "nt", "grid_x", "grid_y",
               "smem")
DW_PLAN_FIELDS = ("m_out", "nz_in", "nz_out", "c", "cout", "stride", "act", "kz", "kpad",
                  "xrows", "ksplit", "wpg", "stages", "pairs", "wm", "wn", "blocks", "smem")
STAGES = (4, 3, 2)  # staged columns per warp (group), the most that fit first
# kernel launches per wrapper; the "_raw" keys count the launches with
# act=False, whose input is a raw tensor: the first conv's (the voxelizer's
# means) and the down convs' (a residual join's applied output). dW there is
# K3's function; the first conv's dx is JAX's split backward, which only an
# input gradient (the pseudo-label perturbation) runs
LAUNCHES = {"fused_bnconv9": 0, "fused_bnconv9_bwd_dx": 0, "fused_bnconv9_dw": 0,
            "fused_bnconv9_dw_raw": 0, "fused_bnconv9_bwd_dx_raw": 0}
_sm_counts = {}
_typed = set()


def _lib(name):
    lib = _build.library(name)
    if name not in _typed:
        p, i32, plan = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)
        if name == "fused_conv.cu":
            lib.toda_fused_bnconv9.argtypes = [p] * 6 + [plan, i32, p]
            lib.toda_fused_bnconv9.restype = i32
            lib.toda_fused_bnconv9_plan_fields.restype = i32
            if lib.toda_fused_bnconv9_plan_fields() != len(PLAN_FIELDS):
                raise RuntimeError("fused_conv.cu and PLAN_FIELDS disagree")
        else:
            lib.toda_bnconv9_bwd_dx.argtypes = [p] * 8 + [plan, i32, p]
            lib.toda_bnconv9_bwd_dx.restype = i32
            lib.toda_bnconv9_dw.argtypes = [p] * 8 + [plan, i32, p]
            lib.toda_bnconv9_dw.restype = i32
        _typed.add(name)
    return lib


def _sm_count(device):
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def conv_plan(kind, c, cout, nz_in, z_stride, esize, m_dst, act=True, sm_count=H100_SMS):
    """The launch plan of K1 (``kind`` "fwd") or K2's dx (``kind`` "dx") on
    an (M, nz_in, C) input, Cout output channels, elements of ``esize``
    bytes and ``m_dst`` destination pillars (output pillars for "fwd", input
    pillars for "dx"): a dict of ``PLAN_FIELDS`` (gather_gemm.cuh).

    One warp owns one destination pillar: ``mt`` 16-row tiles cover its
    ``n_out`` rows, and a block's ``n_blk`` output channels (``nt`` 8-wide
    tiles; ``grid_y`` blocks cover ``n_total``) keep the weights of all 9
    taps in shared memory. Each warp's ``stages`` buffers hold ``buf_rows``
    rows: the source rows at place*r + 1 and every row the products read
    (astride*i + kk // width for i < n_out, kk < kpad; the tile's rows past
    n_out read row 0). The channels are split over blocks only as far as
    the weights need, then the deepest ring that fits is taken. Raises
    ValueError for a shape the kernels do not take."""
    nz_out = out_depth(nz_in, z_stride)
    if kind == "fwd":
        width, n_src, n_out, n_total, place, astride = c, nz_in, nz_out, cout, 1, z_stride
    elif kind == "dx":
        width, n_src, n_out, n_total, place, astride = cout, nz_out, nz_in, c, z_stride, 1
    else:
        raise ValueError(kind)
    if width % 8 or n_total % 8 or not pow2(width * esize // 16) or z_stride not in (1, 2):
        raise ValueError(f"fused_bnconv9 {kind}: C={c} and Cout={cout} must be multiples "
                         f"of 8 with a power-of-two count of 16-byte chunks, z_stride 1 or 2")
    kpad = up(3 * width, 16)
    mt = -(-n_out // 16)
    if mt > 3:
        raise ValueError(f"fused_bnconv9 {kind}: at most 48 z rows, got {n_out}")
    buf_rows = 1 + max(place * (n_src - 1) + 1, astride * (n_out - 1) + (kpad - 1) // width)
    buf_bytes = buf_rows * row_stride(width * esize // 16) * 16

    def smem_of(n_blk, stages):
        if kind == "fwd":  # K-major weights, swizzled; dx's N-major weights padded
            wrows, wstride = 9 * kpad, row_stride(n_blk * esize // 16)
        else:
            wrows, wstride = 9 * n_blk, row_stride(kpad * esize // 16, swizzle=False)
        # the dx channel sums reuse the buffers: (2, WARPS, n_blk) f32
        bufs = max(WARPS * stages * buf_bytes, 2 * WARPS * n_blk * 4)
        return up(8 * c, 128) + wrows * wstride * 16 + bufs

    # split the output channels over blocks until the weights fit
    n_blk = n_total
    while (9 * kpad * n_blk * esize > _WEIGHT_BYTES or smem_of(n_blk, 2) > SMEM_LIMIT) \
            and n_blk % 16 == 0:
        n_blk //= 2
    nt = n_blk // 8
    if nt not in (1, 2, 4, 8):
        raise ValueError(f"fused_bnconv9 {kind}: no channel split of {n_total} fits")
    stages = next((k for k in STAGES if smem_of(n_blk, k) <= SMEM_LIMIT), 2)
    smem = smem_of(n_blk, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_bnconv9 {kind}: C={c}, Cout={cout}, nz {nz_in} needs {smem} "
                         "bytes of shared memory per block")
    per_sm = max(1, min(2, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK)))
    grid_x = max(1, min(-(-m_dst // WARPS), sm_count * per_sm))
    return dict(m_dst=m_dst, n_src=n_src, width=width, n_out=n_out, n_total=n_total, c=c,
                cout=cout, place=place, astride=astride, kpad=kpad, n_blk=n_blk,
                buf_rows=buf_rows, stages=stages, act=int(bool(act)), mt=mt, nt=nt, grid_x=grid_x,
                grid_y=n_total // n_blk, smem=smem)


def dw_plan(c, cout, nz_in, z_stride, esize, m_out, act=True, sm_count=H100_SMS):
    """The launch plan of the dW kernel (K2's dW, K3): a dict of
    ``DW_PLAN_FIELDS`` (fused_conv_bwd.cu). A warp owns ``wm`` x ``wn``
    16x8 tiles of a tap's (3C x Cout) dW, ``wpg`` warps cover it, and the
    block's ``ksplit`` groups of them take turns over runs of ``pairs``
    present pairs of the block's range, each through a ring of ``stages``
    staged runs. ``kz``
    16-row k-steps cover the ``nz_out`` output z rows; a staged x column
    holds ``xrows`` rows (the data at z + 1 and every row the products read
    for z rows below nz_out; the rest read row 0). ``blocks`` (up to two a
    streaming multiprocessor) is fixed by the shape and the card, so two
    runs sum in the same order. Raises ValueError for a shape the kernel
    does not take."""
    nz_out = out_depth(nz_in, z_stride)
    kpad = up(3 * c, 16)
    mtt, ntt = kpad // 16, cout // 8
    if c % 8 or cout % 16 or not (pow2(c * esize // 16) and pow2(cout * esize // 16)) \
            or z_stride not in (1, 2):
        raise ValueError(f"fused_bnconv9_dw: C={c} must be a multiple of 8, Cout={cout} of "
                         "16, each a power-of-two count of 16-byte chunks, z_stride 1 or 2")
    wn = 4 if ntt % 4 == 0 else 2
    wm = 3 if mtt % 3 == 0 else 2
    wpg = (mtt // wm) * (ntt // wn) if mtt % wm == 0 else 0
    if wpg == 0 or WARPS % wpg:
        raise ValueError(f"fused_bnconv9_dw: no warp tiling of a ({3 * c} x {cout}) dW")
    kz = -(-nz_out // 16)
    xrows = 1 + max(nz_in, z_stride * (nz_out - 1) + (kpad - 1) // c)
    xbytes = xrows * row_stride(c * esize // 16) * 16
    gbytes = 16 * kz * row_stride(cout * esize // 16) * 16
    ksplit = WARPS // wpg
    pairs = WARPS // ksplit  # 8 pairs a block a turn

    def smem_of(stages):
        return up(8 * c + 40, 128) + ksplit * stages * pairs * (xbytes + gbytes)

    stages = next((k for k in STAGES if smem_of(k) <= SMEM_LIMIT), 2)
    smem = smem_of(stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_bnconv9_dw: C={c}, Cout={cout}, nz {nz_in} needs {smem} "
                         "bytes of shared memory per block")
    return dict(m_out=m_out, nz_in=nz_in, nz_out=nz_out, c=c, cout=cout, stride=z_stride,
                act=int(bool(act)), kz=kz, kpad=kpad, xrows=xrows, ksplit=ksplit, wpg=wpg,
                stages=stages, pairs=pairs, wm=wm, wn=wn,
                blocks=sm_count * max(1, min(2, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK))),
                smem=smem)


def tap_lists(idx):
    """Each tap's present rows of a (M, 9) tap table, on idx's device with
    no host synchronisation: (pairs, counts). ``pairs[t, :counts[t]]`` are
    the (m, idx[m, t]) with idx[m, t] >= 0, m ascending; (9, M, 2) int32,
    -1 past the count; counts (9,) int32."""
    m = idx.shape[0]
    table = idx.t().contiguous()  # (9, M), tap-major
    present = table >= 0
    counts = present.sum(1, dtype=torch.int32)
    # one prefix sum over the taps laid end to end: a pair's place in its
    # tap's list is its place in all of them less the earlier taps' counts;
    # the missing pairs fill the rest of each list in the same way, so every
    # slot is written once
    before = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    place = torch.cumsum(present.reshape(-1), 0, dtype=torch.int32).view(9, m) - 1
    taps = torch.arange(9, device=idx.device, dtype=torch.int32)[:, None]
    cols = torch.arange(m, device=idx.device, dtype=torch.int32)
    gap = cols - place - 1 + before[:, None]  # place among the tap's missing pairs
    slot = taps * m + torch.where(present, place - before[:, None], counts[:, None] + gap)
    rows = torch.where(present, cols, -1)
    pairs = torch.empty((9 * m, 2), dtype=torch.int32, device=idx.device)
    pairs.index_copy_(0, slot.reshape(-1).long(),
                      torch.stack([rows, torch.where(present, table, -1)], -1).reshape(-1, 2))
    return pairs.view(9, m, 2), counts


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
        x: (M_in, nz_in, C) float32 or bfloat16, contiguous; C % 8 == 0.
        scale, shift: (C,) float32 (the pending BatchNorm affine).
        weights: (3, 3, 3, C, Cout) in (dz, dy, dx) order, x's dtype;
            Cout % 8 == 0.
        idx: (M_out, 9) int32 neighbour table, tap t = dy*3 + dx, -1 missing.
        z_stride: 1 or 2; nz_out = ceil(nz_in / z_stride) <= 48.
    Returns (M_out, nz_out, Cout) in x's dtype. Rows whose taps are all -1
    are zero.
    """
    if x.device.type == "cpu":
        return fused_bnconv9_plain(x, scale, shift, weights, idx, z_stride, act)
    _check_conv_args("fused_bnconv9", x, scale, shift, weights, idx, z_stride)
    m_in, nz_in, c = x.shape
    cout = weights.shape[-1]
    m_out = idx.shape[0]
    plan = conv_plan("fwd", c, cout, nz_in, z_stride, x.element_size(), m_out, act,
                     _sm_count(x.device))
    lib = _lib("fused_conv.cu")
    y = torch.empty((m_out, plan["n_out"], cout), dtype=x.dtype, device=x.device)
    err = lib.toda_fused_bnconv9(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weights.data_ptr(),
        idx.data_ptr(), y.data_ptr(), plan_ints(plan, PLAN_FIELDS), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_bnconv9")
    LAUNCHES["fused_bnconv9"] += 1
    return y


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
            or not gy.is_contiguous() or gy.data_ptr() % 16 or gy.device != x.device:
        raise ValueError(f"fused_bnconv9_bwd_dx: gy must be a contiguous (M_out, {nz_out}, "
                         f"{cout}) {x.dtype} tensor on x's device")
    if invf.shape[0] != m_in:
        raise ValueError("fused_bnconv9_bwd_dx: invf must have one row per input row")
    plan = conv_plan("dx", c, cout, nz_in, z_stride, x.element_size(), m_in, act,
                     _sm_count(x.device))
    lib = _lib("fused_conv_bwd.cu")
    dx = torch.empty_like(x)
    part = torch.empty((2, plan["grid_x"], c), dtype=torch.float32, device=x.device)
    err = lib.toda_bnconv9_bwd_dx(
        gy.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weights.data_ptr(),
        invf.data_ptr(), dx.data_ptr(), part.data_ptr(), plan_ints(plan, PLAN_FIELDS),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_bnconv9_bwd_dx")
    LAUNCHES["fused_bnconv9_bwd_dx"] += 1
    if not act:
        LAUNCHES["fused_bnconv9_bwd_dx_raw"] += 1
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
        (M_out, nz_out, Cout) in x's dtype, contiguous; C a multiple of 8,
        Cout of 16.
    Returns (3, 3, 3, C, Cout) f32.
    """
    if x.device.type == "cpu":
        return fused_bnconv9_dw_plain(x, scale, shift, idx, gy, z_stride, act)
    m_in, nz_in, c = x.shape
    m_out, nz_out, cout = gy.shape
    _check_conv_args("fused_bnconv9_dw", x, scale, shift, None, idx, z_stride)
    if gy.dtype != x.dtype or nz_out != out_depth(nz_in, z_stride) \
            or m_out != idx.shape[0] or not gy.is_contiguous() or gy.data_ptr() % 16 \
            or gy.device != x.device:
        raise ValueError(f"fused_bnconv9_dw: gy must be a contiguous ({idx.shape[0]}, "
                         f"{out_depth(nz_in, z_stride)}, Cout) {x.dtype} tensor on x's device")
    plan = dw_plan(c, cout, nz_in, z_stride, x.element_size(), m_out, act, _sm_count(x.device))
    lib = _lib("fused_conv_bwd.cu")
    pairs, counts = tap_lists(idx)
    part = torch.empty((plan["blocks"], plan["ksplit"], 9, 3 * c, cout), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((3, 3, 3, c, cout), dtype=torch.float32, device=x.device)
    err = lib.toda_bnconv9_dw(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), pairs.data_ptr(), counts.data_ptr(),
        gy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        plan_ints(plan, DW_PLAN_FIELDS), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_bnconv9_dw")
    LAUNCHES["fused_bnconv9_dw"] += 1
    if not act:
        LAUNCHES["fused_bnconv9_dw_raw"] += 1
    return dw


def _check_conv_args(name, x, scale, shift, weights, table, z_stride):
    """The argument checks K1 and its backward kernels share."""
    c = x.shape[-1]
    if not x.is_cuda or x.dtype not in _DTYPE_CODE or x.dim() != 3 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned (M, nz, C) "
                         f"f32/bf16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if weights is not None and (weights.dtype != x.dtype or weights.shape[:4] != (3, 3, 3, c)
                                or weights.dim() != 5 or not weights.is_contiguous()
                                or weights.data_ptr() % 16 or weights.device != x.device):
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
    if z_stride not in (1, 2) or c % 8 != 0:
        raise ValueError(f"{name}: needs z_stride in (1, 2) and C % 8 == 0, "
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
