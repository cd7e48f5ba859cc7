"""The port's data-parallel runtime on the CPU: 2 gloo processes against one.

JAX's one jitted step over the sharded global batch takes BatchNorm
statistics and loss normalisers over the global batch and differentiates
one loss (``tests/test_parallel.py``). The port's ranks each step on a share
of the batch, so these tests hold two gloo processes to one process that
runs the same global batches:

  * ``train_model`` on the tiny CenterPoint-Res (``test_torch_model.tiny``
    widths, f32), two steps, ``TODA_DEBUG_CHECKSUM=1``: per-step losses at
    rtol 2e-4 (as ``test_parallel.py:100`` holds JAX's), the final
    parameters and BatchNorm statistics at rtol 2e-4 (atol 1e-6) wherever
    the step-1 gradient agrees at rtol 2e-4 (``assert_train_matches``);
  * two stage-2 ``make_train_step_cl`` steps on the same model (the
    consistency loss's global pair count) and one tiny SECOND
    ``make_train_step`` step (the anchor head's global batch size), each
    rank on its ``shard_batch`` of the global batches: every loss term and
    the step-1 gradients at rtol 2e-4;
  * ``eval_one_epoch``'s merge: the result dict and the merged annotations
    equal the single-process run's (a deterministic fake predictor, as
    ``test_parallel.py:180``);
  * global-batch statistics: ``MaskedBatchNormT.affine`` and ``bn_apply``
    of a ``GlobalBatchNorm2d`` in training mode, outputs, running statistics
    and the gradients of the inputs and of the affine parameters equal the
    single-process ones (``test_parallel.py:36``).

The workers are this file run as a script (``python
tests/test_torch_parallel.py <mode> <port> <rank> <world> <out> <device>``),
started by the tests with ``subprocess``. On a host with cards, ``python
tests/test_torch_parallel.py cards <world> <dir>`` runs the train parity
with NCCL ranks on ``world`` cards against one card.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from toda_tpu_torch.config import EDict, cfg_from_yaml_file  # noqa: E402

torch.set_num_threads(1)
WORLD = 2
GLOBAL_BATCH = 4


def tiny_cfg():
    """The tiny f32 CenterPoint-Res of ``test_torch_model.tiny``, 8 test-mode
    scenes (no augmentor)."""
    cfg = cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/centerpoint_synthetic.yaml"), EDict())
    d = cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    d.DATA_PROCESSOR[2].NUM_POINTS = {"train": 1024, "test": 1024}
    d.DATA_PROCESSOR[3].VOXEL_SIZE = [0.5, 0.5, 0.5]
    d.DATA_PROCESSOR[3].MAX_NUMBER_OF_VOXELS = {"train": 1024, "test": 1024}
    d.NUM_SCENES = 8
    d.NUM_OBJECTS = [2, 4]
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


class SeededDataset:
    """Draws each frame's point sample from a seed of its own index, so a
    frame is the same whichever process reads it, in whatever order."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        np.random.seed(1000 + int(i))
        return self.ds[int(i)]

    def __getattr__(self, k):
        return getattr(self.ds, k)


def train_loader(rank, world):
    from toda_tpu_torch.datasets import DataLoader, build_dataset

    cfg = tiny_cfg()
    ds = SeededDataset(build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False))
    loader = DataLoader(ds, GLOBAL_BATCH // world, training=True, prefetch=0, rank=rank,
                        world_size=world)
    return cfg, ds, loader


def run_train(cfg, ds, loader, ckpt_dir, device="cpu"):
    """Two train_model steps from seed 0's weights: (losses, final state
    dict, step-1 gradients, the two steps' summed LR), on the CPU."""
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.train_utils import create_train_state, train_model

    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device, seed=0)
    state, _ = create_train_state(bundle, cfg.OPTIMIZATION, 4)
    losses, grads = [], {}

    def record(st, batch, tb, it):
        losses.append(float(tb["loss"]))
        if it == 0:
            grads.update({n: p.grad.cpu() for n, p in bundle.module.named_parameters()})

    train_model(bundle, state, loader, 0, 1, ckpt_dir, hooks=[record])
    final = {k: v.cpu() for k, v in bundle.module.state_dict().items()}
    return losses, final, grads, state.lr_fn(0) + state.lr_fn(1)


class Replay:
    """A loader replaying fixed batches."""

    def __init__(self, dataset, batches):
        self.dataset, self.batches = dataset, batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def reference_train(world, ckpt_dir, device="cpu"):
    """``run_train`` in this process on the global batches of a
    ``world``-rank run: each step's rank shards concatenated in rank order."""
    shards = [train_loader(r, world) for r in range(world)]
    cfg, ds = shards[0][0], shards[0][1]
    keys = ("points", "points_mask", "gt_boxes")
    batches = [{k: np.concatenate([b[k] for b in step]) if k in keys else step[0][k]
                for k in step[0]} for step in zip(*(loader for _, _, loader in shards))]
    assert len(batches) == 2
    return run_train(cfg, ds, Replay(ds, batches), ckpt_dir, device)


def assert_grads_match(got, grads):
    """Step-1 gradients (the summed gradients of the ranks' loss shares) at
    rtol 2e-4, atol 1e-5 of each leaf's largest."""
    assert got.keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=2e-4,
                                   atol=1e-5 * g.abs().max().item(), err_msg=k)


def assert_train_matches(got, ref, params=True):
    """The distributed run's rank-0 dump against ``reference_train``:
    losses and step-1 gradients (``assert_grads_match``) at rtol 2e-4;
    with ``params``, the parameters and BatchNorm statistics after the two
    steps at rtol 2e-4 (atol 1e-6) wherever the element's step-1 gradient
    agrees at rtol 2e-4 with the same sign. Adam divides each element's
    update by that element's own gradient, so where the gradient is at the
    rounding level of its sum (it agrees only through the gradients' atol)
    the summation order sets the size of the update: those elements are
    exempt, at most 1% of the elements, and each within 5% of the two
    steps' summed LR. Returns (sign flips, exempt elements, elements,
    largest gap of the others in units of their tolerance, largest gap of
    the exempt ones in units of the summed LR)."""
    ref_losses, ref_final, grads, lr_sum = ref
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=2e-4)
    assert_grads_match(got["grads"], grads)
    assert got["final"].keys() == ref_final.keys()
    if not params:
        return None
    flips = exempt = 0
    worst = worst_exempt = 0.0
    for k, v in ref_final.items():
        if not v.dtype.is_floating_point:
            assert torch.equal(got["final"][k], v), k
            continue
        a, b = got["final"][k].numpy(), v.numpy()
        live = np.ones(b.shape, bool)
        if k in grads:
            g, h = grads[k].numpy(), got["grads"][k].numpy()
            flips += int((np.sign(g) != np.sign(h)).sum())
            live = (np.sign(g) == np.sign(h)) & (np.abs(h - g) <= 2e-4 * np.abs(g))
            exempt += int((~live).sum())
            worst_exempt = max(worst_exempt, np.abs(a - b)[~live].max(initial=0.0) / lr_sum)
            assert worst_exempt <= 0.05, k
        np.testing.assert_allclose(a[live], b[live], rtol=2e-4, atol=1e-6, err_msg=k)
        gap = np.abs(a - b)[live] / (2e-4 * np.abs(b[live]) + 1e-6)
        worst = max(worst, float(gap.max(initial=0.0)))
    elements = sum(g.numel() for g in grads.values())
    assert exempt <= 0.01 * elements, (exempt, elements)
    return flips, exempt, elements, worst, worst_exempt


def cl_batches():
    """Two global dual batches of 4 from ``CLPairDataset`` over the tiny
    CenterPoint-Res's training set (augmented), the same in every process."""
    from toda_tpu_torch.datasets import build_dataset
    from toda_tpu_torch.datasets.dataset_cl import CLPairDataset

    cfg = tiny_cfg()
    np.random.seed(0)
    cl = CLPairDataset(build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True))
    return cfg, cl, [cl.collate_batch([cl[i] for i in range(j, j + GLOBAL_BATCH)])
                     for j in (0, GLOBAL_BATCH)]


def second_batch():
    """The tiny SECOND (``chip_smoke.second_tiny``) and one global batch of
    4 test-mode scenes with their gt boxes."""
    from chip_smoke import second_tiny

    from toda_tpu_torch.datasets import build_dataset

    cfg = second_tiny(cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/second_synthetic.yaml"), EDict()))
    cfg.DATA_CONFIG.NUM_SCENES = GLOBAL_BATCH
    ds = SeededDataset(build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False))
    return cfg, ds, [ds.collate_batch([ds[i] for i in range(GLOBAL_BATCH)])]


def run_steps(mode, rank=0, world=1, device="cpu"):
    """``mode`` "cl": two ``make_train_step_cl`` steps (consistency weight
    0.1, score threshold 0, so every top-32 box takes part in the
    matching); "second": one SECOND ``make_train_step`` step. Each rank
    takes its ``shard_batch`` (rows rank::world) of each global batch.
    The weights are ``randomize_``'s (seed 0). A gradient compared across
    summation orders is only as stable as the ReLUs it passes: a ReLU input
    within rounding of zero takes either side depending on the order of the
    BatchNorm's sums, which moves that element's cotangent and, through the
    BatchNorm's mean terms, every gradient upstream of it. With the initial
    weights of seed 0 one shared-head ReLU input of the CL org view sits
    there, so the comparison would test rounding, not the reduction; these
    weights are used instead, and a flip under them would show as a failure
    of every leaf upstream of one channel. Returns every step's loss terms
    and the step-1 gradients."""
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.parallel.mesh import data_parallel, shard_batch
    from toda_tpu_torch.runtime.train_cl import make_train_step_cl
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step
    from toda_tpu_torch.weights import randomize_

    cfg, ds, batches = cl_batches() if mode == "cl" else second_batch()
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device)
    randomize_(bundle.module, 0)
    state, _ = create_train_state(bundle, cfg.OPTIMIZATION, 4)
    data_parallel(bundle.module)
    if mode == "cl":
        step = make_train_step_cl(bundle, consistency_weight=0.1, score_thresh=0.0)
        batches = [{v: shard_batch(b[v], rank, world) for v in ("adv", "org")}
                   for b in batches]
    else:
        step = make_train_step(bundle)
        batches = [shard_batch(b, rank, world) for b in batches]
    losses, grads = [], {}
    for i, batch in enumerate(batches):
        state, tb = step(state, batch)
        losses.append({k: float(v) for k, v in tb.items()})
        if i == 0:
            grads = {n: p.grad.cpu() for n, p in bundle.module.named_parameters()}
    return {"losses": losses, "grads": grads}


def assert_steps_match(got, ref):
    """Every step's loss terms and the step-1 gradients at rtol 2e-4."""
    assert len(got["losses"]) == len(ref["losses"])
    for a, b in zip(got["losses"], ref["losses"]):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, err_msg=k)
    assert_grads_match(got["grads"], ref["grads"])


def fake_predict_step(batch):
    """Deterministic detections: one box at the mean of each frame's valid
    points (``tests/dist_eval_worker.py``)."""
    pts = torch.as_tensor(batch["points"])
    w = torch.as_tensor(batch["points_mask"]).float()[..., None]
    center = (pts[..., :3] * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    b, k = pts.shape[0], 4
    boxes = torch.zeros((b, k, 7))
    boxes[:, 0, :3] = center
    boxes[:, 0, 3:6] = torch.tensor([4.0, 2.0, 1.6])
    mask = torch.zeros((b, k), dtype=torch.int32)
    mask[:, 0] = 1
    return {"pred_boxes": boxes, "pred_scores": 0.9 * mask, "pred_labels": mask,
            "pred_mask": mask}


class FakeBundle:
    post_cfg = {"RECALL_THRESH_LIST": [0.3, 0.5]}


def run_eval(dist):
    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.runtime.eval_utils import eval_one_epoch

    np.random.seed(0)
    cfg = tiny_cfg()
    cfg.DATA_CONFIG.NUM_SCENES = 6
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                     dist=dist, workers=1)
    loader.dataset = SeededDataset(ds)
    return eval_one_epoch(FakeBundle(), loader, ds, cfg.CLASS_NAMES,
                          predict_step=fake_predict_step)


def bn_inputs():
    """x (8 pillars, 6 z, 16 channels) with an (8,) pillar mask for
    MaskedBatchNormT, y (4, 8, 6, 6) for the 2D BatchNorm, and fixed
    cotangents for both."""
    rng = np.random.RandomState(0)
    t = {"x": rng.randn(8, 6, 16) * 2 + 1, "mask": rng.rand(8) > 0.3, "gx": rng.randn(8, 6, 16),
         "y": rng.randn(4, 8, 6, 6) * 3 - 1, "gy": rng.randn(4, 8, 6, 6)}
    return {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32))
            for k, v in t.items()}


def run_bn(rank, world):
    """Training-mode MaskedBatchNormT.affine and GlobalBatchNorm2d's bn_apply
    on this rank's rows (rank::world) of ``bn_inputs``: outputs, running
    statistics and gradients (the parameters' summed over the ranks)."""
    from toda_tpu_torch.models.backbones_2d.base_bev_backbone import bn_apply, make_bn
    from toda_tpu_torch.models.backbones_3d.pillar_sparse_backbone import MaskedBatchNormT
    from toda_tpu_torch.parallel.mesh import allreduce_grads, convert_global_batchnorm

    t = {k: v[rank::world] for k, v in bn_inputs().items()}
    net = torch.nn.Module()
    net.tn, net.bn = MaskedBatchNormT(16), make_bn(8)
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            p.copy_(torch.linspace(0.5, 1.5, p.numel()) * (i + 1))
    convert_global_batchnorm(net.train())
    x, y = t["x"].requires_grad_(), t["y"].requires_grad_()
    sc, sh = net.tn.affine(x, t["mask"])
    out_x = x * sc + sh
    out_y = bn_apply(y, net.bn)
    ((out_x * t["gx"]).sum() + (out_y * t["gy"]).sum()).backward()
    allreduce_grads(list(net.parameters()))
    res = {"out_x": out_x, "out_y": out_y, "dx": x.grad, "dy": y.grad}
    res.update({f"grad.{n}": p.grad for n, p in net.named_parameters()})
    res.update({f"buf.{n}": b for n, b in net.named_buffers() if b.dtype.is_floating_point})
    return {k: v.detach() for k, v in res.items()}


def worker(mode, port, rank, world, out, device="cpu"):
    from toda_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in f32 on a card
    init_distributed(f"tcp://127.0.0.1:{port}", world, rank, device=device)
    if mode == "train":
        cfg, ds, loader = train_loader(rank, world)
        losses, final, grads, _ = run_train(cfg, ds, loader, Path(out).parent / "ckpt_dist",
                                            device)
        result = {"losses": losses, "final": final, "grads": grads}
    elif mode in ("cl", "second"):
        result = run_steps(mode, rank, world, device)
    elif mode == "eval":
        res, annos = run_eval(dist=True)
        result = {"result": res, "annos": annos}
    else:
        result = run_bn(rank, world)
        from toda_tpu_torch.utils.commu_utils import all_gather

        result = {"rank": result, "all": all_gather(result)}
    if rank == 0:
        torch.save(result, out)
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(mode, out_dir, world=WORLD, device="cpu"):
    """Start ``world`` workers of this file (gloo on the CPU, NCCL on one
    card each) and return rank 0's dump."""
    out = Path(out_dir) / f"{mode}.pt"
    port = free_port()
    env = dict(os.environ, TODA_DEBUG_CHECKSUM="1", OMP_NUM_THREADS="1")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(port), str(r), str(world),
                               str(out), device], cwd=REPO, env=env) for r in range(world)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    return torch.load(out, weights_only=False)


def test_two_process_train_model_matches_single_process(tmp_path):
    """2-process gloo train_model == one process on the same global batches
    (``assert_train_matches``), with the ranks' checksums compared every
    step; rank 0 wrote the checkpoint."""
    ref = reference_train(WORLD, tmp_path / "ckpt_ref")
    flips, exempt, elements, worst, worst_exempt = assert_train_matches(
        run_workers("train", tmp_path), ref)
    print(f"step-1 gradient sign flips {flips}; exempt parameter elements {exempt} of "
          f"{elements}, within {worst_exempt:.4f} of the summed LR; largest gap of the "
          f"others {worst:.3f} of their tolerance")
    assert (tmp_path / "ckpt_dist" / "checkpoint_epoch_1.pth").exists()


def test_two_process_cl_steps_match_single_process(tmp_path):
    """2-process gloo ``make_train_step_cl`` == one process on the same
    global dual batches: each view's BatchNorm statistics, both detection
    losses and the consistency loss's matched-pair count are the global
    batch's, and the summed gradients are the global loss's."""
    ref = run_steps("cl")
    got = run_workers("cl", tmp_path)
    assert all(s["consistency_center"] > 0 for s in ref["losses"])
    assert_steps_match(got, ref)


def test_two_process_second_step_matches_single_process(tmp_path):
    """2-process gloo SECOND ``make_train_step`` == one process on the same
    global batch: the anchor head's losses divide by the global batch size,
    the legacy contract's ``MaskedBatchNormT`` takes global statistics."""
    ref = run_steps("second")
    assert_steps_match(run_workers("second", tmp_path), ref)


def check_on_cards(world, out_dir):
    """The train parity on CUDA: ``world`` NCCL ranks, one card each,
    against one process on cuda:0 (``python tests/test_torch_parallel.py
    cards <world> <dir>`` on a host with that many cards)."""
    from toda_tpu_torch.ops import _build

    if torch.cuda.device_count() < world:
        raise SystemExit(f"needs {world} cards, found {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    ref = reference_train(world, Path(out_dir) / "ckpt_ref", device="cuda")
    got = run_workers("train", out_dir, world, device="cuda")
    assert_train_matches(got, ref, params=False)
    print(f"cards: {world} NCCL ranks == one card on the same global batches (losses "
          f"{got['losses']} vs {ref[0]}, step-1 gradients; the ranks' parameter checksums "
          f"equal every step)")


def test_two_process_eval_merge_matches_single_process(tmp_path):
    ref, ref_annos = run_eval(dist=False)
    got = run_workers("eval", tmp_path)
    assert got["result"].keys() == ref.keys()
    for k, v in ref.items():
        if k not in ("sec_per_example", "compile_sec"):
            assert abs(got["result"][k] - float(v)) < 1e-6, (k, got["result"][k], v)
    assert len(got["annos"]) == len(ref_annos) == 6
    for a, b in zip(got["annos"], ref_annos):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_global_batch_norm_statistics_and_gradients(tmp_path):
    ref = run_bn(0, 1)
    got = run_workers("bn", tmp_path)
    for k in ("out_x", "out_y", "dx", "dy"):
        merged = torch.empty_like(ref[k])
        for r, part in enumerate(got["all"]):
            merged[r::WORLD] = part[k]
        np.testing.assert_allclose(merged.numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k, v in ref.items():
        if k.startswith(("grad.", "buf.")):
            for part in got["all"]:
                np.testing.assert_allclose(part[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=k)


def test_world_size_one_collectives_are_identities():
    from toda_tpu_torch.parallel import mesh
    from toda_tpu_torch.utils import commu_utils as cu

    assert mesh.get_dist_info() == (0, 1) and cu.get_world_size() == 1
    assert cu.all_gather({"a": 1}) == [{"a": 1}]
    assert cu.average_reduce_value(3.5) == 3.5
    assert cu.reduce_dict({"x": 2.0}) == {"x": 2.0}
    assert cu.merge_results_dist([1, 2, 3], total_size=3) == [1, 2, 3]
    np.testing.assert_array_equal(cu.concat_all_gather(np.arange(4)), np.arange(4))
    cu.synchronize()
    t = torch.ones(3)
    assert mesh.global_count(t) is t and mesh.global_moments(t) is t
    batch = {"points": np.zeros((4, 2)), "batch_size": 4}
    assert mesh.shard_batch(batch) is batch
    assert mesh.shard_batch(batch, 1, 2)["points"].shape == (2, 2)
    net = torch.nn.Sequential(torch.nn.BatchNorm2d(3))
    assert type(mesh.convert_global_batchnorm(net)[0]) is torch.nn.BatchNorm2d
    assert mesh.init_distributed(world_size=1) == (0, 1)
    p = torch.nn.Parameter(torch.ones(2))
    mesh.allreduce_grads([p])
    assert p.grad is None


def test_commu_utils_merge_interleaves_ranks():
    """The merge restores dataset order from rank-strided shares and cuts
    the padded tail (world size 1 is the identity; the interleave is
    checked on a stand-in gather)."""
    from toda_tpu_torch.utils import commu_utils as cu

    real = cu.all_gather
    try:
        cu.all_gather = lambda data: [[0, 2, 4], [1, 3, 0]]
        assert cu.merge_results_dist(None, 5) == [0, 1, 2, 3, 4]
        cu.all_gather = lambda data: [[0, 2, 4, 6], [1, 3]]
        assert cu.merge_results_dist(None, 6) == [0, 1, 2, 3, 4, 6]
    finally:
        cu.all_gather = real


def test_rank_strided_loader_pads_and_interleaves():
    """Each rank reads every world-th frame of the index list padded with
    its head to a multiple of the world size, as the JAX loader does."""
    import toda_tpu.datasets as jd

    from toda_tpu_torch.datasets import DataLoader

    class Frames:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return i

        @staticmethod
        def collate_batch(samples):
            return list(samples)

    for n, world, bs, training in ((7, 2, 2, False), (7, 3, 1, True), (8, 4, 2, True)):
        for rank in range(world):
            mine = DataLoader(Frames(n), bs, training=training, prefetch=0, rank=rank,
                              world_size=world)
            ref = jd.DataLoader(Frames(n), bs, shuffle=training, drop_last=training,
                                rank=rank, world_size=world, prefetch=0)
            mine.set_epoch(3)
            ref.set_epoch(3)
            assert len(mine) == len(ref)
            np.testing.assert_array_equal(mine._indices(), ref._indices())
            if training:
                assert list(mine) == list(ref)


if __name__ == "__main__":
    if sys.argv[1] == "cards":
        check_on_cards(int(sys.argv[2]), sys.argv[3])
    else:
        mode, port, rank, world, out, device = sys.argv[1:7]
        worker(mode, int(port), int(rank), int(world), out, device)
