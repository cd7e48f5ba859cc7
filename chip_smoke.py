#!/usr/bin/env python3
"""Drive the PyTorch port (``toda_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py   # the phases below, on cuda:0

Phases (none catches its own failure; any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the slice from ``toda_tpu_torch/csrc`` (one
     nvcc per source, in parallel, into ``build/kernels``);
  3. tiny CenterPoint-Res in f32 on cuda and on cpu with the same weights and
     batch: the head outputs must agree;
  4. full-width CenterPoint-Res (the TODA flagship widths) at the scale of
     bench.py's ``centerpoint`` workload: one forward records the inputs each
     kernel gets on the main path; every kernel is held against its plain
     PyTorch version on those inputs and timed beside it;
  5. with every launch counter at 0, ``eval_one_epoch`` over several batches
     of 4 scans: outputs must be finite and each kernel must have launched
     (K1 11 times per forward); then the steady-state predict throughput and
     peak memory;
  6. a torch.profiler window over two predict steps: kernel time by name and
     the device's busy share of the steady step;
  7. tiny CenterPoint-Res in f32: three train steps on cuda and on cpu from
     the same weights and batch: losses and parameters must agree;
  8. full-width training (batch 4, augmentor on): one recorded train step
     feeds each backward kernel's inputs (K2's dx and dW on every layer, K3:
     dW of the four raw-input layers, K6) to it and to its plain version; a
     second dW run must be bit-equal to the first;
  9. with every launch counter at 0, 20 ``make_train_step`` steps: launches
     per step asserted, losses finite; then the steady train throughput
     (loss read back every step) and peak memory;
 10. a torch.profiler window over two train steps;
 11. one {"kernels": [...]} line, then the {"ok": true, "device": ...} line.
Exits non-zero with no result when there is no CUDA device or the port is
missing.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 4
N_BATCHES = 5
SEED = 0
TRAIN_STEPS = 20
SCHEDULE_STEPS = 100  # OneCycle length: every step here stays in its warm-up
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[0]


def base_cfg():
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    return cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/centerpoint_synthetic.yaml"), EDict())


def full_cfg():
    """bench.py's ``centerpoint`` workload: range [-54, 54]^2 x [-5, 3],
    voxel (0.075, 0.075, 0.2) -> 1440 x 1440 x 40, 131072 points per scan,
    MAX_PILLARS 49152, 100k background points, 20-40 objects."""
    cfg = base_cfg()
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": 131072, "test": 131072}
        if proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.075, 0.075, 0.2]
            proc.MAX_POINTS_PER_VOXEL = 10
            proc.MAX_NUMBER_OF_VOXELS = {"train": 120000, "test": 120000}
    cfg.MODEL.BACKBONE_3D.MAX_PILLARS = 49152
    cfg.DATA_CONFIG.NUM_BACKGROUND_POINTS = 100000
    cfg.DATA_CONFIG.NUM_OBJECTS = [20, 40]
    cfg.DATA_CONFIG.MAX_GT_BOXES = 64
    cfg.DATA_CONFIG.NUM_SCENES = BATCH * N_BATCHES
    return cfg


def tiny_cfg():
    cfg = base_cfg()
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    cfg.DATA_CONFIG.DATA_PROCESSOR[2].NUM_POINTS = {"train": 1024, "test": 1024}
    cfg.DATA_CONFIG.DATA_PROCESSOR[3].VOXEL_SIZE = [0.5, 0.5, 0.5]
    cfg.DATA_CONFIG.NUM_SCENES = 2
    cfg.DATA_CONFIG.NUM_OBJECTS = [2, 4]
    m = cfg.MODEL
    m.BACKBONE_3D.CHANNELS = [16, 16, 16, 16]
    m.BACKBONE_3D.MAX_PILLARS = 1024
    m.BACKBONE_3D.BF16 = False
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.BACKBONE_2D.LAYER_STRIDES = [1, 2]
    m.BACKBONE_2D.NUM_FILTERS = [16, 32]
    m.BACKBONE_2D.UPSAMPLE_STRIDES = [1, 2]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    return cfg


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over iters launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_tiny_parity():
    """Tiny f32 model: cuda vs cpu on the same weights and batch."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.weights import randomize_

    cfg = tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2)
    batch = next(iter(loader))
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    randomize_(cpu.module, SEED)
    gpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cuda")
    gpu.module.load_state_dict(cpu.module.state_dict(), strict=True)
    out_c = cpu.forward(cpu.to_device(batch))
    out_g = gpu.forward(gpu.to_device(batch))
    tol = 1e-3  # f32 on both sides, TF32 off: only summation order differs
    worst = 0.0
    pairs = [("spatial_features_2d", out_c["spatial_features_2d"], out_g["spatial_features_2d"])]
    pairs += [(k, out_c["center_pred_dicts"][0][k], v)
              for k, v in out_g["center_pred_dicts"][0].items()]
    for name, a, b in pairs:
        b = b.cpu()
        err = (a - b).abs().max().item()
        worst = max(worst, err / max(1.0, a.abs().max().item()))
        assert torch.allclose(a, b, rtol=tol, atol=tol), f"tiny cuda/cpu {name}: max err {err}"
    log(f"phase tiny cuda-vs-cpu (f32): head outputs agree, max rel err {worst:.3g} (tol {tol})")


def update_mismatches(final, ref_final, init, ref_grads, lr_sum):
    """The parameters whose update (final - init) after a few optimizer steps
    differs from the reference's by more than 1e-3 of ``lr_sum`` (the sum of
    the steps' LRs, the farthest an Adam step sequence moves a leaf) on an
    element whose first-step reference gradient is above 1e-3 of its leaf's
    largest. Adam moves a leaf by about LR * sign(g), so where g is within
    rounding of 0 the two sides may step apart; those elements are held to
    2 * lr_sum only. A wrong decay mask or a wrong b1 schedule moves the
    update by 1e-2 of lr_sum or more. Returns ([(name, err, tol)] of the
    leaves that fail, the largest error on a live element / lr_sum)."""
    bad, worst = [], 0.0
    for name, g in ref_grads.items():
        want = (ref_final[name].double() - init[name].double()).cpu()
        err = (final[name].double().cpu() - init[name].double().cpu() - want).abs()
        g = g.abs().double().cpu()
        live = g > 1e-3 * g.max()
        worst = max(worst, err[live].max().item() / lr_sum)
        for sel, tol in ((live, 1e-3 * lr_sum), (~live, 2 * lr_sum)):
            if sel.any() and err[sel].max().item() > tol:
                bad.append((name, err[sel].max().item(), tol))
    return bad, worst


def phase_tiny_train_parity():
    """Tiny f32 model: three train steps on cuda and on cpu from the same
    weights and batch. Losses agree to 1e-3 relative, each parameter's
    update as ``update_mismatches`` says, the BatchNorm running statistics
    to 1e-4."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step

    cfg = tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                     training=True)
    batch = next(iter(loader))
    runs = []
    for device in ("cpu", "cuda"):
        bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device, seed=SEED)
        state, _ = create_train_state(bundle, cfg.OPTIMIZATION, 10)
        init = {k: v.detach().cpu().clone() for k, v in bundle.module.state_dict().items()}
        step = make_train_step(bundle)
        losses, grads = [], None
        for _ in range(3):
            losses.append(float(step(state, batch)[1]["loss"]))
            if grads is None:
                grads = {n: p.grad.cpu().clone() for n, p in bundle.module.named_parameters()}
        runs.append((losses, bundle.module.state_dict(), init, grads, state))
    (lc, sdc, init, gc, opt), (lg, sdg, init_g, _, _) = runs
    for a, b in zip(lc, lg):
        assert abs(a - b) <= 1e-3 * abs(a), f"tiny train cuda/cpu losses {lc} vs {lg}"
    assert all(torch.equal(init[k], init_g[k]) for k in init), "the two inits differ"
    lr_sum = sum(opt.lr_fn(i) for i in range(3))
    bad, worst = update_mismatches(sdg, sdc, init, gc, lr_sum)
    assert not bad, f"tiny train cuda/cpu updates differ: {bad[:5]}"
    for k in sdc:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(sdg[k].cpu(), sdc[k], rtol=1e-4, atol=1e-4), k
    log(f"phase tiny train cuda-vs-cpu (f32, 3 steps): losses {lc} vs {lg}; every "
        f"update within 1e-3 x sum(LR) where the step-1 gradient is live (max err "
        f"{worst:.3g} x sum(LR)); BN statistics within 1e-4")


class Recorder:
    """Records the arguments of each call to a kernel wrapper, as seen
    from one module, while it is installed there."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from toda_tpu_torch.ops import fused_conv, gather

    for counts in (fused_conv.LAUNCHES, gather.LAUNCHES):
        for k in counts:
            counts[k] = 0


def k1_work(x, weights, idx, z_stride):
    """(bytes, flops) of one K1 call on these inputs: each input read once,
    the output written once; 2*C*Cout flops per (output row, valid tap,
    in-range dz)."""
    import torch

    m_in, nz_in, c = x.shape
    cout = weights.shape[-1]
    nz_out = -(-nz_in // z_stride)
    eb = x.element_size()
    nbytes = (x.numel() * eb + weights.numel() * eb + idx.numel() * 4 + 2 * c * 4
              + idx.shape[0] * nz_out * cout * eb)
    taps = int(torch.count_nonzero(idx >= 0).item())
    return nbytes, 2 * c * cout * taps * z_pairs(nz_in, z_stride)


def z_pairs(nz_in, z_stride, backward=False):
    """(output z, dz) pairs of a conv that read an input z in range (forward),
    or (input z, dz) pairs that read a staged output row (backward)."""
    nz_out = -(-nz_in // z_stride)
    if not backward:
        return sum(1 for zo in range(nz_out) for dz in range(3)
                   if 0 <= z_stride * zo + dz - 1 < nz_in)
    return sum(1 for z in range(nz_in) for dz in range(3)
               if z + 1 - dz >= 0 and (z + 1 - dz) % z_stride == 0
               and (z + 1 - dz) // z_stride < nz_out)


def dx_work(x, w, invf, gy, z_stride):
    """(bytes, flops) of one dx call: x, gy, w, invf read once, dx written
    once; 2*C*Cout flops per (input row, valid inverse tap, valid (z, dz))."""
    import torch

    c, cout = x.shape[-1], gy.shape[-1]
    eb = x.element_size()
    nbytes = (2 * x.numel() + gy.numel() + w.numel()) * eb + invf.numel() * 4 + 4 * c * 4
    taps = int(torch.count_nonzero(invf >= 0).item())
    return nbytes, 2 * c * cout * taps * z_pairs(x.shape[1], z_stride, backward=True)


def dw_work(x, idx, gy, z_stride):
    """(bytes, flops) of one dW call: x, gy, idx read once, the f32 dW
    written once; 2*C*Cout flops per (output row, valid tap, in-range dz)."""
    import torch

    c, cout = x.shape[-1], gy.shape[-1]
    eb = x.element_size()
    nbytes = (x.numel() + gy.numel()) * eb + idx.numel() * 4 + 27 * c * cout * 4 + 2 * c * 4
    taps = int(torch.count_nonzero(idx >= 0).item())
    return nbytes, 2 * c * cout * taps * z_pairs(x.shape[1], z_stride)


def dx_tolerance(x, scale, w, invf, gy, z_stride, act, ref):
    """Per-element tolerance of a dx against its plain version ``ref``: one
    bf16 ulp of the element (f32 sums in another order, then rounded to
    bf16) plus 2^-12 of the sum of its terms' magnitudes |gy| |w| (|scale|).
    A dropped tap, a lost relu mask or a zero row moves an element by far
    more."""
    import torch

    from toda_tpu_torch.ops import fused_conv

    mag = fused_conv.fused_bnconv9_bwd_plain(
        x, torch.ones_like(scale), torch.zeros_like(scale), w.abs(), invf, gy.abs(), z_stride,
        False)[0].float()
    if act:
        mag = mag * scale.abs()
    return 2.0 ** -7 * ref.float().abs() + 2.0 ** -12 * mag


def bound_ms(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(bundle, batch):
    """Record the kernels' inputs on one full-width forward, then hold each
    kernel against its plain version on them and time both."""
    import torch

    from toda_tpu_torch.ops import fused_conv, gather, pillar_sparse

    with Recorder(fused_conv, "fused_bnconv9") as k1, \
            Recorder(pillar_sparse, "scatter_rows_add") as k4, \
            Recorder(pillar_sparse, "unpack_pillars") as k5:
        out = bundle.forward(bundle.to_device(batch))
    torch.cuda.synchronize()
    for k, v in out["center_pred_dicts"][0].items():
        assert torch.isfinite(v).all(), f"full-width head output {k} is not finite"
    assert len(k1.calls) == 11 and len(k4.calls) == 2 and len(k5.calls) == 1, \
        (len(k1.calls), len(k4.calls), len(k5.calls))

    rows = {"K1": [], "K4": [], "K5": []}
    for (x, sc, sh, w, idx, s, act), _ in k1.calls:
        y = fused_conv.fused_bnconv9(x, sc, sh, w, idx, s, act)
        ref = fused_conv.fused_bnconv9_plain(x, sc, sh, w, idx, s, act)
        err = (y.float() - ref.float()).abs()
        tol = 2.0 ** -7  # two bf16 ulps: sum order differs, output rounds to bf16
        assert bool((err <= tol + tol * ref.float().abs()).all()), \
            f"K1 {tuple(x.shape)}->{tuple(y.shape)}: max err {err.max().item()}"
        nbytes, flops = k1_work(x, w, idx, s)
        peak = H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS
        rows["K1"].append(dict(
            shape=f"x{tuple(x.shape)} s{s} act{int(act)} -> y{tuple(y.shape)}",
            err=err.max().item(), tol=f"{tol:g} abs + rel",
            ms=cuda_ms(lambda: fused_conv.fused_bnconv9(x, sc, sh, w, idx, s, act), 10),
            plain_ms=cuda_ms(lambda: fused_conv.fused_bnconv9_plain(x, sc, sh, w, idx, s, act), 3),
            library_ms=None, bound=bound_ms(nbytes, flops, peak)))
    for (g, idx, n), _ in k4.calls:
        y = gather.scatter_rows_add(g, idx, n)
        ref = gather.scatter_rows_add_plain(g, idx, n)
        err = (y - ref).abs()
        assert bool((err <= 1e-5 + 1e-5 * ref.abs()).all()), \
            f"K4 {tuple(g.shape)}->{n}: max err {err.max().item()}"
        safe = torch.where(idx >= 0, idx.long(), n)
        gf = g.float()
        buf = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32, device=g.device)
        nbytes = g.numel() * g.element_size() + idx.numel() * 4 + n * g.shape[1] * 4
        rows["K4"].append(dict(
            shape=f"g{tuple(g.shape)} {g.dtype} -> ({n}, {g.shape[1]})",
            err=err.max().item(), tol="1e-05 abs + rel",
            ms=cuda_ms(lambda: gather.scatter_rows_add(g, idx, n), 10),
            plain_ms=cuda_ms(lambda: gather.scatter_rows_add_plain(g, idx, n), 10),
            library_ms=cuda_ms(lambda: buf.index_add_(0, safe, gf), 10),
            bound=bound_ms(nbytes, g.numel(), H100_F32_FLOPS)))
    for (sums, c, cpad, dtype), _ in k5.calls:
        y = gather.unpack_pillars(sums, c, cpad, dtype)
        ref = gather.unpack_pillars_plain(sums, c, cpad, dtype)
        err = (y.float() - ref.float()).abs().max().item()
        assert err == 0.0, f"K5: max err {err} (the same IEEE division and rounding)"
        nbytes = sums.numel() * 4 + y.numel() * y.element_size()
        rows["K5"].append(dict(
            shape=f"sums{tuple(sums.shape)} -> {tuple(y.shape)} {dtype}",
            err=err, tol="0 (exact)",
            ms=cuda_ms(lambda: gather.unpack_pillars(sums, c, cpad, dtype), 10),
            plain_ms=cuda_ms(lambda: gather.unpack_pillars_plain(sums, c, cpad, dtype), 10),
            library_ms=None, bound=bound_ms(nbytes, sums.shape[0] * c * 2, H100_F32_FLOPS)))
    log_rows(rows)
    return rows


def log_rows(rows):
    for name, rs in rows.items():
        for r in rs:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"  {name} {r['shape']}: max_abs_err {r['err']:.3g} (tol {r['tol']}), "
                f"ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, library_ms {lib}, "
                f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})")


def check_train_kernels(dx_calls, dw_calls, gather_calls):
    """Hold each recorded backward call's kernel against its plain version
    and time both; returns the K2, K3 and K6 rows."""
    import torch

    from toda_tpu_torch.ops import fused_conv, gather

    rows = {"K2": [], "K3": [], "K6": []}
    for (x, sc, sh, w, invf, gy, s, act), _ in dx_calls:
        dx, dsc, dsh = fused_conv.fused_bnconv9_bwd_dx(x, sc, sh, w, invf, gy, s, act)
        rdx, rsc, rsh = fused_conv.fused_bnconv9_bwd_plain(x, sc, sh, w, invf, gy, s, act)
        tol = dx_tolerance(x, sc, w, invf, gy, s, act, rdx)

        def dx_ok(v):
            return bool(((v.float() - rdx.float()).abs() <= tol).all())

        err = (dx.float() - rdx.float()).abs()
        assert dx_ok(dx), f"K2 dx {tuple(x.shape)}: max err {err.max().item()}"
        # the check itself: the plain dx with the centre inverse tap dropped,
        # and an all-zero dx, must fail it
        dropped = invf.clone()
        dropped[:, 4] = -1
        assert not dx_ok(fused_conv.fused_bnconv9_bwd_plain(
            x, sc, sh, w, dropped, gy, s, act)[0]), "the dx check passes a dropped tap"
        assert not dx_ok(torch.zeros_like(dx)), "the dx check passes a zero dx"
        # f32 channel sums over ~10^8 rows in another order: bounded by
        # 3e-5 of the sum of the terms' magnitudes (cancellation leaves the
        # sums themselves far smaller)
        g = (rdx.float() / sc).abs()
        for a, b, mag, name in ((dsc, rsc, (g * x.float().abs()).sum((0, 1)), "dscale"),
                                (dsh, rsh, g.sum((0, 1)), "dshift")):
            e = (a - b).abs()
            assert bool((e <= 3e-5 * mag + 1e-6).all()), f"K2 {name}: max err {e.max().item()}"
        nbytes, flops = dx_work(x, w, invf, gy, s)
        peak = H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS
        rows["K2"].append(dict(
            shape=f"dx x{tuple(x.shape)} gy{tuple(gy.shape)} s{s}",
            err=err.max().item(), tol="2^-7 rel + 2^-12 x sum|terms|",
            ms=cuda_ms(lambda: fused_conv.fused_bnconv9_bwd_dx(x, sc, sh, w, invf, gy, s, act), 5),
            plain_ms=cuda_ms(lambda: fused_conv.fused_bnconv9_bwd_plain(
                x, sc, sh, w, invf, gy, s, act), 2),
            library_ms=None, bound=bound_ms(nbytes, flops, peak)))
    for (x, sc, sh, idx, gy, s, act), _ in dw_calls:
        dw = fused_conv.fused_bnconv9_dw(x, sc, sh, idx, gy, s, act)
        again = fused_conv.fused_bnconv9_dw(x, sc, sh, idx, gy, s, act)
        assert torch.equal(dw, again), "dW: two runs differ (the sum order must be fixed)"
        ref = fused_conv.fused_bnconv9_dw_plain(x, sc, sh, idx, gy, s, act)
        # f32 sums over ~10^7 rows in another order: within 3e-5 of the sum
        # of the terms' magnitudes (the activation is >= 0 when act)
        mag = fused_conv.fused_bnconv9_dw_plain(x if act else x.abs(), sc, sh, idx, gy.abs(),
                                                s, act)
        err = (dw - ref).abs()
        tol = 3e-5 * mag + 1e-6
        assert bool((err <= tol).all()), \
            f"dW {tuple(x.shape)} act {act}: max err {err.max().item()}"
        err = err.max().item()
        nbytes, flops = dw_work(x, idx, gy, s)
        peak = H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS
        rows["K2" if act else "K3"].append(dict(
            shape=f"dW x{tuple(x.shape)} gy{tuple(gy.shape)} s{s} act{int(act)}",
            err=err, tol="3e-05 x sum|terms|, bit-equal reruns",
            ms=cuda_ms(lambda: fused_conv.fused_bnconv9_dw(x, sc, sh, idx, gy, s, act), 5),
            plain_ms=cuda_ms(lambda: fused_conv.fused_bnconv9_dw_plain(
                x, sc, sh, idx, gy, s, act), 2),
            library_ms=None, bound=bound_ms(nbytes, flops, peak)))
    ((table, idx), _), = gather_calls
    out = gather.gather_rows(table, idx)
    assert torch.equal(out, gather.gather_rows_plain(table, idx)), "K6 differs from plain"
    padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    safe = torch.where(idx >= 0, idx.long(), table.shape[0])
    row_bytes = table.shape[1] * table.element_size()
    nbytes = (int(torch.count_nonzero(idx >= 0).item()) + idx.numel()) * row_bytes \
        + idx.numel() * 4
    rows["K6"].append(dict(
        shape=f"table{tuple(table.shape)} {table.dtype} idx({idx.numel()},)",
        err=0.0, tol="0 (exact)",
        ms=cuda_ms(lambda: gather.gather_rows(table, idx), 10),
        plain_ms=cuda_ms(lambda: gather.gather_rows_plain(table, idx), 10),
        library_ms=cuda_ms(lambda: padded.index_select(0, safe), 10),
        bound=bound_ms(nbytes, 0, H100_F32_FLOPS)))
    return rows


def phase_train_kernels(state, step, batch):
    """Record the backward kernels' inputs on one full-width train step, then
    hold each kernel against its plain version on them and time both."""
    import torch

    from toda_tpu_torch.ops import fused_conv, pillar_sparse

    with Recorder(fused_conv, "fused_bnconv9_bwd_dx") as kdx, \
            Recorder(fused_conv, "fused_bnconv9_dw") as kdw, \
            Recorder(pillar_sparse, "gather_rows") as k6:
        _, tb = step(state, batch)
        loss = float(tb["loss"])
    assert math.isfinite(loss), loss
    assert len(kdx.calls) == 10 and len(kdw.calls) == 11 and len(k6.calls) == 1, \
        (len(kdx.calls), len(kdw.calls), len(k6.calls))

    # the recorded scale, shift and weights carry autograd history: check
    # without recording, or every plain version keeps its whole graph alive
    with torch.no_grad():
        rows = check_train_kernels(kdx.calls, kdw.calls, k6.calls)
    log(f"phase train kernels: recorded step loss {loss:.4f}")
    log_rows(rows)
    return rows


def phase_main_path(bundle, cfg, loader, dataset):
    """eval_one_epoch with every counter at 0; then steady predict throughput."""
    import numpy as np
    import torch

    from toda_tpu_torch.ops import fused_conv, gather
    from toda_tpu_torch.runtime.eval_utils import eval_one_epoch

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, annos = eval_one_epoch(bundle, loader, dataset, cfg.CLASS_NAMES)
    wall = time.time() - t0
    launches = {"K1": fused_conv.LAUNCHES["fused_bnconv9"],
                "K4": gather.LAUNCHES["scatter_rows_add"],
                "K5": gather.LAUNCHES["unpack_pillars"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_fwd = len(loader)
    assert launches["K1"] == 11 * n_fwd, launches
    assert launches["K4"] == 2 * n_fwd and launches["K5"] == n_fwd, launches
    assert len(annos) == BATCH * n_fwd
    for a in annos:
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    n_det = sum(len(a["score"]) for a in annos)
    log(f"phase main path: eval_one_epoch over {n_fwd} batches of {BATCH} in {wall:.1f}s; "
        f"launches {launches}; {n_det} detections, all finite; "
        f"mAP {result['mAP']:.4f}, recall/0.3 {result['recall/0.3']:.4f}; "
        f"eval sec/example {result['sec_per_example']:.4f} "
        f"({1.0 / result['sec_per_example']:.2f} scans/s incl. host recall + mAP prep); "
        f"peak device memory {peak_gib:.2f} GiB")

    # steady-state predict (forward + decode + NMS) as bench.py times it:
    # device-resident batches, one host readback per step, best of 3 passes
    dev_batches = [bundle.to_device(b) for b in loader]
    bundle.predict(dev_batches[0])
    torch.cuda.synchronize()
    iters, best = 10, 0.0
    for _ in range(3):
        t = time.time()
        check = 0.0
        for i in range(iters):
            dets = bundle.predict(dev_batches[i % len(dev_batches)])
            check += float(dets["pred_scores"][0, 0])
        assert math.isfinite(check)
        best = max(best, iters * BATCH / (time.time() - t))
    log(f"phase predict throughput: {best:.2f} scans/s steady state (batch {BATCH}, "
        f"best of 3 x {iters} steps)")
    return launches, best


def phase_train_main(bundle, state, step, batches):
    """TRAIN_STEPS make_train_step steps with every counter at 0, loss read
    back every step; then the steady train throughput and peak memory."""
    import torch

    from toda_tpu_torch.ops import fused_conv, gather

    # dW runs with act=False (K3's function) on the four raw-input layers:
    # stage 1's first conv and the three down convs, whose inputs are the
    # residual joins' applied outputs
    per_step = {"K1": 11, "K2dx": 10, "dW": 11, "K6": 1, "K4": 2, "K5": 1, "dW_raw": 4}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    losses = []
    for i in range(TRAIN_STEPS):
        state, tb = step(state, batches[i % len(batches)])
        losses.append(float(tb["loss"]))
    wall = time.time() - t0
    fc, ga = fused_conv.LAUNCHES, gather.LAUNCHES
    launches = {"K1": fc["fused_bnconv9"], "K2dx": fc["fused_bnconv9_bwd_dx"],
                "dW": fc["fused_bnconv9_dw"], "K6": ga["gather_rows"],
                "K4": ga["scatter_rows_add"], "K5": ga["unpack_pillars"],
                "dW_raw": fc["fused_bnconv9_dw_raw"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert launches == {k: n * TRAIN_STEPS for k, n in per_step.items()}, launches
    assert all(math.isfinite(v) for v in losses), losses
    log(f"phase train main path: {TRAIN_STEPS} make_train_step steps (batch {BATCH}, "
        f"numpy batches in) in {wall:.1f}s; launches {launches}; losses "
        f"{[round(v, 4) for v in losses]}; peak device memory {peak_gib:.2f} GiB")

    # steady state as bench.py times training: device-resident batches, the
    # loss read back every step, best of 3 passes
    dev_batches = [bundle.to_device(b) for b in batches]
    step(state, dev_batches[0])
    torch.cuda.synchronize()
    iters, best = 10, 0.0
    for _ in range(3):
        t = time.time()
        for i in range(iters):
            _, tb = step(state, dev_batches[i % len(dev_batches)])
            assert math.isfinite(float(tb["loss"]))
        best = max(best, iters * BATCH / (time.time() - t))
    log(f"phase train throughput: {best:.2f} scans/s steady state (batch {BATCH}, best of "
        f"3 x {iters} steps, loss read back every step)")
    return launches, best, peak_gib, dev_batches[0]


def phase_profile(run, what):
    """Kernel time by name over 2 steps of ``run`` (torch.profiler), and the
    device's busy share of the steady step time measured just before."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    step_ms = (time.time() - t) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 2e3
    log(f"profile {what}: steady step {step_ms:.1f} ms (host clock, batch {BATCH}); device "
        f"kernel time {dev_ms:.1f} ms per step; busy share {dev_ms / step_ms:.3f}")
    log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "toda_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: toda_tpu_torch is missing next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # f32 convolutions and products in full f32 (the tiny parity check)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.ops import _build
    from toda_tpu_torch.weights import randomize_

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t = time.time()
    _build.build_all()
    log(f"phase build: {len(_build.SOURCES)} sources in {time.time() - t:.1f}s")
    for name, out in _build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase_tiny_parity()
    phase_tiny_train_parity()

    cfg = full_cfg()
    np.random.seed(SEED)
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device="cuda")
    randomize_(bundle.module, SEED)
    first = next(iter(loader))
    log(f"full width: grid {dataset.grid_size.tolist()}, {first['points'].shape[1]} points/scan, "
        f"{int(first['points_mask'].sum(1).min())}-{int(first['points_mask'].sum(1).max())} real")
    rows = phase_kernels(bundle, first)
    launches, scans_per_s = phase_main_path(bundle, cfg, loader, dataset)
    dev = bundle.to_device(first)
    phase_profile(lambda: bundle.predict(dev), "predict")
    del bundle, dev

    # training at the same widths and scale, augmentor on, JAX-like init
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step

    np.random.seed(SEED)
    tdataset, tloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH,
                                            training=True)
    tbatches = list(tloader)
    tbundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), tdataset, device="cuda", seed=SEED)
    state, _ = create_train_state(tbundle, cfg.OPTIMIZATION, SCHEDULE_STEPS)
    step = make_train_step(tbundle)
    log(f"training: {len(tbatches)} batches of {BATCH} augmented scans, "
        f"{int(sum((b['gt_boxes'][..., -1] > 0).sum() for b in tbatches))} gt boxes")
    rows.update(phase_train_kernels(state, step, tbatches[0]))
    tlaunches, train_scans, train_peak, tdev = phase_train_main(tbundle, state, step, tbatches)
    phase_profile(lambda: float(step(state, tdev)[1]["loss"]), "train step")
    launches.update({"K2": tlaunches["K2dx"] + tlaunches["dW"] - tlaunches["dW_raw"],
                     "K3": tlaunches["dW_raw"], "K6": tlaunches["K6"]})

    meta = {
        "K1": ("fused_bnconv9", "toda_tpu_torch/csrc/fused_conv.cu",
               "toda_tpu/ops/pallas_fused_conv.py:475"),
        "K2": ("fused_bnconv9_bwd_dx + fused_bnconv9_dw", "toda_tpu_torch/csrc/fused_conv_bwd.cu",
               "toda_tpu/ops/pallas_fused_conv.py:934"),
        "K3": ("fused_bnconv9_dw (act=False)", "toda_tpu_torch/csrc/fused_conv_bwd.cu",
               "toda_tpu/ops/pallas_fused_conv.py:736"),
        "K4": ("scatter_rows_add", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:925"),
        "K5": ("unpack_pillars", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:1200"),
        "K6": ("gather_rows", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:97"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        rs = rows[key]
        bnd = sum(r["bound"][0] for r in rs)
        by_ops = sum(r["bound"][0] for r in rs if r["bound"][1] == "operations")
        libs = [r["library_ms"] for r in rs]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": bnd,
            "bound_by": "operations" if by_ops * 2 > bnd else "bytes",
            "library_ms": None if any(v is None for v in libs) else sum(libs),
        })
    log(f"(kernel times are summed over the kernel's calls: K1, K4, K5 per forward of batch "
        f"{BATCH}, launches over eval_one_epoch; K2, K3, K6 per train step, launches over "
        f"{TRAIN_STEPS} train steps; {scans_per_s:.2f} predict scans/s, {train_scans:.2f} "
        f"train scans/s, train peak memory {train_peak:.2f} GiB on {card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
