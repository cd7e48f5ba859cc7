"""Probe of the column gathers' and K10's design choices on the H100, on the
recorded calls of one full-width SECOND train step (``chip_smoke.second_cfg``,
legacy contract): 18 K7 (``gather9_stacked_t``) and 12 K8
(``gather_rows_taps_t``) calls, and the 7 stride-1 convs of its forward for
K10 (``gather9_conv_t``, seeded He-normal weights as ``chip_smoke.phase_k10``
gives them).

- K7 and K8: the column-gather kernel at slice heights of 16, 32 and 64 table
  rows (``gather.column_gather_rows`` picks one: the ``rule`` column) and,
  with ``--parent-source``, the previous kernels of another tree's
  ``gather.cu`` (C entries ``toda_gather9_stacked_t`` /
  ``toda_gather_rows_taps_t``), each held equal to the parent's output;
- K10: ``gather.cu`` as it is against a copy whose level-reuse product path
  (C % 16 == 0, Cout <= 32) is switched off, so those calls take the generic
  bf16 product; both are held against ``gather9_conv_t_plain``.

Each variant is timed in turns, three rounds, with CUDA events; the median
round is printed. Needs one CUDA card and nvcc; the variants are built into
``build/kernels/probe/``. Run from the repository root:

    python3 probe_column_gathers.py [--parent-source OTHER_TREE/toda_tpu_torch/csrc/gather.cu]
"""

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke
from toda_tpu_torch.ops import _build, _plan, gather, pillar_sparse

REUSE_BRANCH = "      if (p.c % 16 == 0) {"


def build(sources):
    """Compile each (name -> source text) at once; the loaded libraries."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, lib in libs.items():
        if name == "parent":
            lib.toda_gather9_stacked_t.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, p]
            lib.toda_gather_rows_taps_t.argtypes = [p, p, p, i64, i64, i32, i32, i32, p]
        else:
            lib.toda_gather_cols.argtypes = [p, p, p, i64, i64] + [i32] * 6 + [p]
            lib.toda_gather9_conv_t.argtypes = [p, p, p, p, i64, i64,
                                                ctypes.POINTER(ctypes.c_int32), i32, i32, p]
    return libs


def median_rounds(fns, iters):
    """{variant: median over three rounds of its mean ms}, the variants timed
    in turns within each round."""
    res = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            res[k].append(smoke.cuda_ms(fn, iters))
    return {k: sorted(v)[1] for k, v in res.items()}


def record_second_step():
    """The K7 and K8 calls of one SECOND train step, and {haloed W: (nz, C)}."""
    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step

    cfg = smoke.second_cfg()
    np.random.seed(smoke.SEED)
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                          batch_size=smoke.BATCH, training=True)
    batch = next(iter(loader))
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device="cuda",
                           seed=smoke.SEED)
    state, _ = create_train_state(bundle, cfg.OPTIMIZATION, smoke.SCHEDULE_STEPS)
    step = make_train_step(bundle)
    nz, layer_shapes = int(dataset.grid_size[2]), {}
    for ch in cfg.MODEL.BACKBONE_3D.CHANNELS:
        layer_shapes[(nz + 2) * ch] = (nz, ch)
        nz = -(-nz // 2)
    with smoke.Recorder(pillar_sparse, "gather9_stacked_t") as k7, \
            smoke.Recorder(pillar_sparse, "gather_rows_taps_t") as k8:
        step(state, batch)
    return k7.calls, k8.calls, layer_shapes


def probe_gathers(kind, calls, libs):
    stream = torch.cuda.current_stream().cuda_stream
    totals = {}
    for (table, idx), kw in calls:
        (w, n), (m, ntap) = table.shape, idx.shape
        chunk = kw.get("chunk")
        it = gather._stacked_identity(kw.get("identity_tap"), m, n)
        it = -1 if it is None else it
        ref = gather.gather9_stacked_t_plain(table, idx, chunk=chunk,
                                             identity_tap=kw.get("identity_tap")) \
            if kind == "K7" else gather.gather_rows_taps_t_plain(table, idx).view(ntap * w, m)
        out = torch.empty_like(ref)

        def cols(rows):
            assert libs["new"].toda_gather_cols(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m, ntap, w,
                table.element_size(), chunk or 0, it, rows, stream) == 0

        fns = {}
        if "parent" in libs:
            if kind == "K7":
                fns["parent"] = lambda: libs["parent"].toda_gather9_stacked_t(
                    table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m, w,
                    table.element_size(), chunk or 0, it, stream)
            else:
                fns["parent"] = lambda: libs["parent"].toda_gather_rows_taps_t(
                    table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m, ntap, w,
                    table.element_size(), stream)
        for rows in (16, 32, 64):
            fns[rows] = lambda rows=rows: cols(rows)
        for k, fn in fns.items():
            out.zero_()
            assert fn() in (0, None)
            assert torch.equal(out, ref), f"{kind} {k} differs from its plain version"
        ms = median_rounds(fns, 20)
        for k, v in ms.items():
            totals[k] = totals.get(k, 0.0) + v
        print(f"{kind} table{tuple(table.shape)} idx{tuple(idx.shape)} chunk {chunk} rule "
              f"{gather.column_gather_rows(n, m, ntap, table.element_size())}: "
              + " ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        del ref, out
    print(f"{kind} summed over {len(calls)} calls: "
          + " ".join(f"{k} {v:.4f}" for k, v in totals.items()), flush=True)


def probe_k10(calls, layer_shapes, libs):
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(smoke.SEED)
    totals = {}
    forward = [call for call in calls if "chunk" not in call[1]]
    for (table, idx), kw in forward:
        nz, c = layer_shapes[table.shape[0]]
        n, m = table.shape[1], idx.shape[0]
        it = gather._stacked_identity(kw.get("identity_tap"), m, n)
        w = (torch.randn((3, 3, 3, c, c), generator=gen) * (2.0 / (27 * c)) ** 0.5).to(
            device="cuda", dtype=table.dtype)
        plan = gather.conv_t_plan(c, c, nz, table.element_size(), m)
        packed = gather.pack_conv_t_weights(w, plan)
        ints = _plan.plan_ints(plan, gather.CONV_T_PLAN_FIELDS)
        out = torch.empty((nz * c, m), dtype=table.dtype, device="cuda")
        ref = gather.gather9_conv_t_plain(table, idx, w, nz, it).float()
        fns = {v: (lambda v=v: libs[v].toda_gather9_conv_t(
            table.data_ptr(), idx.data_ptr(), packed.data_ptr(), out.data_ptr(), n, m, ints,
            -1 if it is None else it, 1, stream)) for v in ("generic", "new")}
        errs = {}
        for k, fn in fns.items():
            assert fn() == 0
            errs[k] = (out.float() - ref).abs().max().item()
        ms = median_rounds(fns, 10)
        for k, v in ms.items():
            totals[k] = totals.get(k, 0.0) + v
        print(f"K10 table{tuple(table.shape)} nz{nz} C=Cout={c}: "
              + " ".join(f"{k} {ms[k]:.4f} (max err {errs[k]:.3g})" for k in fns), flush=True)
    print(f"K10 summed over {len(forward)} calls: "
          + " ".join(f"{k} {v:.4f}" for k, v in totals.items()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="another tree's gather.cu, timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_column_gathers: no CUDA device", file=sys.stderr)
        return 2
    src = (_build.CSRC / "gather.cu").read_text()
    if src.count(REUSE_BRANCH) != 1:
        raise RuntimeError("gather.cu: K10's level-reuse branch not found")
    sources = {"new": src, "generic": src.replace(REUSE_BRANCH,
                                                  REUSE_BRANCH.replace("if (", "if (false && "))}
    if args.parent_source:
        with open(args.parent_source) as f:
            sources["parent"] = f.read()
    libs = build(sources)
    print(smoke.card_line(), flush=True)
    k7_calls, k8_calls, layer_shapes = record_second_step()
    torch.cuda.empty_cache()
    with torch.no_grad():
        probe_gathers("K8", k8_calls, libs)
        probe_gathers("K7", k7_calls, libs)
        probe_k10(k7_calls, layer_shapes, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
