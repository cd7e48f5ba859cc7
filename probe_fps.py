"""Probe of farthest point sampling (FPS) on the H100, at the PV-RCNN forward's
call: the raw points of the first batch of ``chip_smoke.pvrcnn_cfg``'s
synthetic Waymo scenes (4 scans of 196,608 points, a mask), 4096 samples.

- This tree's kernel through ``pointnet2_ops.fps_run``: (a) FPS, (b) mode
  1, the distance update skipped (the step's argmax chain alone), (c) mode
  2, empty steps (a ``__syncthreads()`` and one push and wait through the
  blocks' mbarriers a step: this design's latency floor), and the wrapper;
  then copies of ``pointnet2.cu`` with other block geometries (warps a block
  x points a thread, text-patched), each held equal to the plain version.
- ``--parent-source FILE``: the single-pass cluster kernel the bucketed one
  replaced (``pointnet2.cu`` of an older tree, whose C entry is
  ``toda_fps(points, mask, out, b, n, ns, stream)``, e.g. ``git show
  4551cc6:toda_tpu_torch/csrc/pointnet2.cu``): (a) as it is, (b) with the
  distance update cut out, (c) with empty steps, one ``cluster.sync()`` and
  one distributed-shared-memory read a step. (c) x 4095 is the latency
  floor of a design that takes one cluster barrier a step.

Each variant is timed in turns, three rounds, with CUDA events; the median
round is printed, the parent (when given) first and last in each round. The
nvcc register and spill lines of every FPS kernel are printed. Needs one
CUDA card and nvcc; the copies are built into ``build/kernels/probe/``. Run
from the repository root:

    python3 probe_fps.py [--parent-source FILE]

``--share`` needs no card: it counts, on the CPU, the groups (a kernel
thread's points) the pruning updates a step, with
``farthest_point_sampling_buckets``'s algorithm on the call's first scan.
"""

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke
from toda_tpu_torch.ops import _build
from toda_tpu_torch.ops import pointnet2_ops as p2

NS = 4096
# the geometry's constants in pointnet2.cu, and the copies' values:
# (warps a block, points a thread up to 196,608 points, points a thread above)
GEOMETRY = ("constexpr int kFpsWarps = {};", "constexpr int kFpsSmallP = {};",
            "constexpr int kFpsLargeP = {};")
TREE_GEOMETRY = (16, 24, 32)
GEOMETRIES = {"16 warps x 32 points": (16, 32, 32), "32 warps x 12 points": (32, 12, 16),
              "32 warps x 16 points": (32, 16, 16), "8 warps x 48 points": (8, 48, 48)}
# the parent's step loop and update loop, cut out for splits (b) and (c)
STEP_OPEN = "  for (int s = 0; s < ns; ++s) {\n"
STEP_CLOSE = "  // no block leaves while another may still read its slots\n"
UPDATE_OPEN = "    } else {\n      const float lx = win.x, ly = win.y, lz = win.z;\n"
UPDATE_CLOSE = "    }\n    warp_argmax(bd, bi);\n"
EMPTY_STEP = """  for (int s = 0; s < ns; ++s) {
    if (threadIdx.x == 0) slot[s & 1].i = s;
    cluster.sync();
    if (threadIdx.x == 0) {
      const Best b = *cluster.map_shared_rank(&slot[s & 1], (rank + 1) % kFpsCtas);
      if (rank == 0) out[(int64_t)scan * ns + s] = b.i;
    }
  }
"""


def geometry_variant(text, geometry):
    """This tree's pointnet2.cu with another (warps, small P, large P)."""
    for line, old, new in zip(GEOMETRY, TREE_GEOMETRY, geometry):
        if text.count(line.format(old)) != 1:
            raise RuntimeError(f"pointnet2.cu: {line.format(old)!r} not found once")
        text = text.replace(line.format(old), line.format(new))
    return text


def cut(text, open_, close, body):
    """text with [open_, close) replaced by body; each marker must occur once."""
    if text.count(open_) != 1 or text.count(close) != 1:
        raise RuntimeError(f"marker not found once: {open_!r} / {close!r}")
    i, j = text.index(open_), text.index(close)
    return text[:i] + body + text[j:]


def parent_variants(text):
    """{name: source} of the parent's splits (a), (b), (c)."""
    chain = cut(text, UPDATE_OPEN, UPDATE_CLOSE,
                "    } else {\n      bd = dist[0];\n      bi = lo + (int)threadIdx.x;\n")
    return {"parent (a)": text, "parent (b)": chain,
            "parent (c)": cut(text, STEP_OPEN, STEP_CLOSE, EMPTY_STEP)}


def build(sources):
    """One nvcc a (name -> source text), all started together, into
    build/kernels/probe/: ({name: loaded library}, {name: FPS ptxas lines})."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = out_dir / f"fps_{i}.cu"
        path.write_text(text)
        so = out_dir / f"fps_{i}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = libs[name] = ctypes.CDLL(str(so))
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.toda_fps.restype = i32
        if name.startswith("parent"):
            lib.toda_fps.argtypes = [p, p, p, i32, i32, i32, p]
        else:
            lib.toda_fps.argtypes = [p, p, p, p, ctypes.c_size_t, i32, i32, i32, i32, p]
            lib.toda_fps_workspace.argtypes = [i32, i32]
            lib.toda_fps_workspace.restype = ctypes.c_size_t
        logs[name] = fps_ptxas(out)
    return libs, logs


def fps_ptxas(out):
    """The ptxas lines of nvcc's -Xptxas -v output that describe FPS kernels:
    from each 'Compiling entry' line naming one to the next entry."""
    keep, lines = False, []
    for ln in out.splitlines():
        if "Compiling entry" in ln:
            keep = "fps_kernel" in ln or "fps_keys_kernel" in ln
        if keep:
            lines.append(ln.strip())
    return lines


def median_rounds(fns, iters):
    """{variant: median over three rounds of its mean ms}, the variants timed
    in turns within each round (the order of ``fns``)."""
    res = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            res[k].append(smoke.cuda_ms(fn, iters, warmup=1))
    return {k: sorted(v)[1] for k, v in res.items()}


def forward_points(device):
    """The raw points and mask the PV-RCNN forward's FPS call gets on the
    first batch of ``pvrcnn_cfg``'s scenes."""
    from toda_tpu_torch.datasets import build_dataloader

    cfg = smoke.pvrcnn_cfg()
    np.random.seed(smoke.SEED)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=smoke.BATCH)
    batch = next(iter(loader))
    points = torch.as_tensor(np.asarray(batch["points"]))[..., :3].contiguous().to(device)
    mask = torch.as_tensor(np.asarray(batch["points_mask"])).to(device)
    return points, mask


def variant_fn(lib, points, mask, out):
    """A call of a copy of this tree's toda_fps (mode 0), with its workspace."""
    b, n, _ = points.shape
    work = torch.empty(lib.toda_fps_workspace(b, n), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check(lib.toda_fps(points.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                  work.data_ptr(), work.numel(), b, n, NS, 0, stream),
                     "toda_fps copy")
    return run


def parent_fn(lib, points, mask, out):
    b, n, _ = points.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check(lib.toda_fps(points.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n, NS,
                                  stream), "parent toda_fps")
    return run


def update_share():
    """On the CPU: the bucketed plain FPS (groups of a kernel thread's 24
    sorted points) on the first scan of the PV-RCNN call, step by step: the
    groups it updates, and the warps of the busiest block with an updated
    group (chunk c of 32 groups in block c % 16, warp c // 16; 16 warps a
    block), by ranges of steps."""
    group, warps = TREE_GEOMETRY[1], TREE_GEOMETRY[0]
    pts, mask = forward_points("cpu")
    pts, mask = pts[:1], mask[:1]
    n = pts.shape[1]
    g = -(-n // group)
    order = torch.argsort(p2.fps_sort_keys(pts, mask), dim=1, stable=True)[0]
    p = pts[0, order].view(g, group, 3)
    idx = order.view(g, group)
    lo, hi = p2.fps_boxes(p, mask[0, order].view(g, group))
    dist = torch.where(mask[0, order], p2.BIG, -p2.BIG).float().view(g, group)
    best = p2.fps_key(dist, idx).amax(-1)
    chunk = torch.arange(g) // 32
    block, warp = chunk % p2.FPS_CTAS, chunk // p2.FPS_CTAS
    updated, busiest = [], []
    for _ in range(NS - 1):
        s = pts[0, int(p2.fps_key_index(best.max()))]
        upd = p2.fps_lower_bound(lo, hi, s) < dist.amax(-1)
        dist = torch.where(upd[:, None], torch.minimum(dist, p2.sq_dist(p, s)), dist)
        best = torch.where(upd, p2.fps_key(dist, idx).amax(-1), best)
        u = upd.nonzero()[:, 0]
        updated.append(len(u))
        warps_hit = torch.unique(block[u] * warps + warp[u])
        busiest.append(int(torch.bincount(warps_hit // warps, minlength=p2.FPS_CTAS).max())
                       if len(u) else 0)
    updated, busiest = np.array(updated), np.array(busiest)
    print(f"FPS update share (CPU count): {g} groups of {group} sorted points, {NS - 1} steps "
          f"after the first: {updated.mean() / g:.4f} of the groups a step", flush=True)
    for a, b in ((0, 10), (10, 100), (100, 1000), (1000, NS - 1)):
        print(f"  steps {a}-{b}: {updated[a:b].mean():.1f} groups updated a step; the busiest "
              f"block's warps with an update {busiest[a:b].mean():.2f} (at most "
              f"{busiest[a:b].max()})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="an older tree's pointnet2.cu, split and timed beside")
    ap.add_argument("--share", action="store_true",
                    help="only count, on the CPU, the groups the pruning updates a step")
    args = ap.parse_args()
    if args.share:
        update_share()
        return 0
    if not torch.cuda.is_available():
        print("probe_fps: no CUDA device", file=sys.stderr)
        return 2
    sources = {}
    if args.parent_source:
        with open(args.parent_source) as f:
            sources.update(parent_variants(f.read()))
    tree = (_build.CSRC / "pointnet2.cu").read_text()
    sources.update({name: geometry_variant(tree, g) for name, g in GEOMETRIES.items()})
    _build.build_all()
    libs, logs = build(sources)
    logs["tree, 16 warps x 24 / 32 points"] = fps_ptxas(_build.build_logs.get("pointnet2.cu", ""))
    print(smoke.card_line(), flush=True)
    for name, lines in logs.items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}", flush=True)
    points, mask = forward_points("cuda")
    b, n, _ = points.shape
    print(f"FPS call: points{tuple(points.shape)}, {int(mask.sum())} valid, {NS} samples",
          flush=True)
    want = p2.farthest_point_sampling_plain(points, mask, NS)
    fns = {}
    for name, lib in libs.items():
        out = torch.empty((b, NS), dtype=torch.int32, device="cuda")
        make = parent_fn if name.startswith("parent") else variant_fn
        fns[name] = make(lib, points, mask, out)
        fns[name]()
        torch.cuda.synchronize()
        if name != "parent (b)" and name != "parent (c)":
            assert torch.equal(out, want), f"{name} differs from the plain version"
    for mode in (0, 1, 2):
        fns[f"tree ({'abc'[mode]})"] = lambda mode=mode: p2.fps_run(points, mask, NS, mode)
    assert torch.equal(p2.fps_run(points, mask, NS), want), "FPS differs from the plain version"
    fns["tree (wrapper)"] = lambda: p2.farthest_point_sampling(points, mask, NS)
    if "parent (a)" in fns:
        fns["parent (a) again"] = fns["parent (a)"]
    times = median_rounds(fns, 5)
    for k, t in times.items():
        print(f"  {k}: {t:.4f} ms, {1e3 * t / (NS - 1):.4f} us a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
