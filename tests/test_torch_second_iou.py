"""SECOND-IoU: the PyTorch port against the JAX package.

The ops: ``boxes_iou3d`` on random rotated boxes with touching, nested and
disjoint pairs and padded rows (1e-5 absolute), ``points_in_boxes`` /
``points_box_id`` / the per-RoI point count (exact). The head on its own
(``SECONDHead`` with JAX's weights carried by ``state_dict_from_flax``, a
random BEV map and RoIs reaching past the map): the pooled grid, the IoU
scores and logits (1e-5 of each output's largest), ``second_head_loss``
and every ``rescore_detections`` score type. The whole tiny detector
(``second_iou_synthetic.yaml`` cut by ``chip_smoke.second_tiny``; the port
on its fused conv contract, JAX on its XLA one): the IoU loss alone gives
the 3D and 2D backbones and the anchor head an exactly zero gradient; three
train steps against JAX's (losses, step-1 gradients, updates, BatchNorm
statistics, held as ``test_torch_second.py`` holds SECOND); the
post-processing with both rescorings keeps JAX's detections. JAX's steps
compose ``bundle.loss``'s value and gradient with
``TrainState.apply_gradients`` as its ``make_train_step`` does (this
detector draws no random numbers in a step), so one compile gives the
step-1 gradients and the three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import second_tiny, update_mismatches
from test_torch_model import jit_o0, random_tree
from test_torch_parta2 import assert_close_to_max
from test_torch_second import flax_init_tree

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.models import build_network as j_build_network
from toda_tpu.models.roi_heads import second_head as j_second_head
from toda_tpu.ops.points_in_boxes import points_box_id as j_points_box_id
from toda_tpu.ops.points_in_boxes import points_in_boxes as j_points_in_boxes
from toda_tpu.ops.rotated_iou import boxes_iou3d as j_boxes_iou3d
from toda_tpu.runtime import optimization as j_optimization
from toda_tpu.runtime import train_utils as j_train_utils
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.models.roi_heads import second_head
from toda_tpu_torch.ops import points_in_boxes as pib
from toda_tpu_torch.ops.rotated_iou import boxes_iou3d
from toda_tpu_torch.runtime import train_utils
from toda_tpu_torch.weights import init_like_flax_, state_dict_from_flax

torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/second_iou_synthetic.yaml"
STEPS = 3
TOTAL_STEPS = 10
PC_RANGE = (-16.0, -16.0, -3.0, 16.0, 16.0, 1.0)
VOXEL = (0.5, 0.5, 0.5)
ANCHORS = 256  # the tiny grid's 8 x 8 BEV cells x 2 classes x 2 rotations
SCORE_TYPES = ("weighted_iou_cls", "num_pts_iou_cls")
HEAD_CFG = {"NUM_ROIS": 6, "ROI_GRID_SIZE": 3, "SHARED_FC": [16, 8], "BEV_STRIDE": 8}


def t(x):
    return torch.as_tensor(np.asarray(x))


def box_pairs(rng):
    """(A (N, 7), B (M, 7)) rotated boxes holding touching, nested, disjoint,
    overlapping and padded (all-zero) rows."""
    a = np.zeros((8, 7), np.float32)
    a[:, :2] = rng.uniform(-5, 5, (8, 2))
    a[:, 2] = rng.uniform(-1, 1, 8)
    a[:, 3:6] = rng.uniform(0.5, 4.0, (8, 3))
    a[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    a[7] = 0  # padding
    b = a.copy()
    b[0, :2] += a[0, 3] * np.array([np.cos(a[0, 6]), np.sin(a[0, 6])])  # touching faces
    b[1, 3:6] *= 0.5  # nested
    b[2, :2] += 50.0  # disjoint
    b[3, 2] += a[3, 5]  # stacked: touching in z
    b[4, :3] += rng.uniform(-0.5, 0.5, 3)  # overlapping
    b[4, 6] += 0.3
    b[5:7] = rng.uniform(-3, 3, (2, 7))
    b[5:7, 3:6] = np.abs(b[5:7, 3:6]) + 0.5
    return a, np.concatenate([b, np.zeros((2, 7), np.float32)])


def test_boxes_iou3d_equals_jax():
    """(N, M) 3D IoU within 1e-5 absolute of JAX's, with the touching,
    nested, disjoint and padded cases at their known values."""
    a, b = box_pairs(np.random.RandomState(0))
    got = boxes_iou3d(t(a), t(b)).numpy()
    want = np.asarray(j_boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[0, 0] < 1e-5 and got[2, 2] == 0 and got[3, 3] < 1e-5
    assert abs(got[1, 1] - 0.125) < 1e-5 and 0.1 < got[4, 4] < 1
    assert (got[7] == 0).all() and (got[:, 8:] == 0).all()
    batched = boxes_iou3d(t(np.stack([a, a[::-1]])), t(np.stack([b, b]))).numpy()
    np.testing.assert_allclose(batched[0], got, rtol=0, atol=0)


def test_points_in_boxes_equal_jax():
    """Membership, first-box ids and per-box counts of the valid points,
    equal to JAX's, a padding box holding no point."""
    rng = np.random.RandomState(1)
    pts = rng.uniform(-6, 6, (3000, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, 3000)
    boxes = box_pairs(rng)[0]
    got = pib.points_in_boxes(t(pts), t(boxes)).numpy()
    want = np.asarray(j_points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)
    assert got[:7].sum() > 100 and not got[7].any()
    np.testing.assert_array_equal(
        pib.points_box_id(t(pts), t(boxes)).numpy(),
        np.asarray(j_points_box_id(jnp.asarray(pts), jnp.asarray(boxes))))
    mask = rng.rand(2, 3000) < 0.8
    batch = np.stack([pts, pts[::-1]])
    counts = pib.count_points_in_boxes(t(batch), t(mask), t(np.stack([boxes, boxes])),
                                       block=3).numpy()
    for i in range(2):
        jm = np.asarray(j_points_in_boxes(jnp.asarray(batch[i]), jnp.asarray(boxes)))
        np.testing.assert_array_equal(counts[i], (jm & mask[i][None]).sum(1))


@pytest.fixture(scope="module")
def head():
    """JAX's SECONDHead and the port's with the same weights, on one random
    (B, H, W, C) BEV map and RoIs, some reaching past the map's edge."""
    rng = np.random.RandomState(2)
    b, n, h, w, c = 2, HEAD_CFG["NUM_ROIS"], 8, 8, 5
    fmap = rng.standard_normal((b, h, w, c)).astype(np.float32)
    rois = np.zeros((b, n, 7), np.float32)
    rois[..., :2] = rng.uniform(-24, 24, (b, n, 2))
    rois[..., 2] = rng.uniform(-2, 0, (b, n))
    rois[..., 3:6] = rng.uniform(1, 6, (b, n, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    jhead = j_second_head.SECONDHead(model_cfg=HEAD_CFG, input_channels=c,
                                     point_cloud_range=PC_RANGE, voxel_size=VOXEL, bev_stride=8)
    batch = {"spatial_features_2d": jnp.asarray(fmap), "rois": jnp.asarray(rois)}
    params = jax.tree_util.tree_map(np.asarray, jit_o0(jhead.init)(jax.random.PRNGKey(0), batch))
    params = jax.tree_util.tree_map(lambda v: v + 0.1 * rng.standard_normal(v.shape)
                                    .astype(np.float32), params)
    jout = jit_o0(jhead.apply)(params, dict(batch))
    port = second_head.SECONDHead(HEAD_CFG, c, PC_RANGE, VOXEL, 8)
    port.load_state_dict(state_dict_from_flax(params, port), strict=True)
    pout = port({"spatial_features_2d": t(fmap).permute(0, 3, 1, 2), "rois": t(rois)})
    grid = second_head.rotated_roi_grid(t(rois), 3, PC_RANGE, 8, VOXEL)
    jgrid = jax.vmap(lambda r: j_second_head.rotated_roi_grid(r, 3, PC_RANGE, 8, VOXEL))(rois)
    pooled = second_head.bilinear_sample(t(fmap), grid)
    jpooled = jax.vmap(j_second_head.bilinear_sample)(jnp.asarray(fmap), jgrid)
    return dict(fmap=fmap, rois=rois, jout=jout, pout=pout, grid=(grid, jgrid),
                pooled=(pooled, jpooled), port=port)


def test_head_pooling_equals_jax(head):
    """The RoI grids' pixel coordinates (1e-5 of the largest) and the
    bilinear samples (1e-5 of the largest), zero where every neighbour lies
    off the map."""
    grid, jgrid = head["grid"]
    assert_close_to_max(grid.numpy(), jgrid, 1e-5, "grid")
    outside = ((grid < -1) | (grid >= 8)).any(-1)
    assert outside.any() and (~outside).any()
    pooled, jpooled = head["pooled"]
    assert_close_to_max(pooled.numpy(), jpooled, 1e-5, "pooled")
    assert (pooled[outside] == 0).all()


def test_head_outputs_equal_jax(head):
    """The IoU logits and scores through the carried shared_fc_{i} and
    iou_head (with their biases), flattened in JAX's (gy, gx, C) order."""
    for k in ("roi_ious", "roi_iou_logits"):
        assert_close_to_max(head["pout"][k].detach().numpy(), head["jout"][k], 1e-5, k)


def test_second_head_loss_equals_jax(head):
    """The smooth-L1 IoU loss against JAX's to 1e-6 relative, with gt boxes
    padded, some on the RoIs (IoU targets near 1)."""
    rng = np.random.RandomState(3)
    rois = head["rois"]
    gt = np.zeros((2, 5, 8), np.float32)
    gt[:, :3, :7] = rois[:, :3] + rng.uniform(-0.2, 0.2, (2, 3, 7)).astype(np.float32)
    gt[:, :3, 7] = 1
    gt[0, 3, :7], gt[0, 3, 7] = rois[0, 4], 0  # a padded row on a RoI counts nothing
    got, tb = second_head.second_head_loss(head["pout"], t(gt))
    want, _ = jit_o0(j_second_head.second_head_loss)(head["jout"], jnp.asarray(gt))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    assert set(tb) == {"rcnn_loss_iou"}


@pytest.mark.parametrize("score_type", ["cls", "iou", "weighted_iou_cls", "num_pts_iou_cls"])
def test_rescore_detections_equal_jax(score_type):
    """Each final-score rule, with point counts across the 10-90 clip."""
    rng = np.random.RandomState(4)
    cls, iou = rng.rand(2, 40).astype(np.float32), rng.rand(2, 40).astype(np.float32)
    num = rng.randint(0, 200, (2, 40)).astype(np.int32)
    got = second_head.rescore_detections(t(cls), t(iou), t(num), score_type, 0.6).numpy()
    want = j_second_head.rescore_detections(jnp.asarray(cls), jnp.asarray(iou), jnp.asarray(num),
                                            score_type, 0.6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def tiny(cfg, fused=False):
    """``chip_smoke.second_tiny`` of a loaded second_iou_synthetic.yaml, with
    every anchor a RoI (NUM_ROIS ``ANCHORS``): the top-K then orders the
    anchors but selects none, so two anchors whose scores tie within f32
    rounding (the port's sums and JAX's differ in order) cannot swap one
    RoI for another between steps. Such a swap changes the IoU head's
    gradient, and through the global-norm clip every update."""
    cfg = second_tiny(cfg, fused)
    cfg.MODEL.ROI_HEAD.NUM_ROIS = ANCHORS
    return cfg


def _port(training=False, fused=True):
    pcfg = tiny(cfg_from_yaml_file(CFG, EDict()), fused)
    return pcfg, build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                               build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES,
                                             training=training), device="cpu")


def test_init_like_flax_heads():
    """``init_like_flax_`` gives the head's Dense layers flax's LeCun
    normal kernels (a unit normal truncated at two sigmas, scaled to std
    fan_in^-1/2) and zero biases."""
    _, pb = _port()
    head = init_like_flax_(pb.module, 5).roi_head
    for name in ("shared_fc_0", "shared_fc_1", "iou_head"):
        lin = getattr(head, name)
        std = lin.in_features ** -0.5
        assert (lin.bias == 0).all() and lin.weight.abs().max() <= 2 * std / 0.8796 + 1e-6
    w = head.shared_fc_0.weight.detach()
    assert abs(float(w.std()) / head.shared_fc_0.in_features ** -0.5 - 1) < 0.05


def test_iou_loss_does_not_backprop_into_backbones():
    """The IoU loss alone gives the 3D and 2D backbones and the anchor head
    an exactly zero gradient, and the head's FCs a nonzero one (JAX's
    ``test_second_iou_loss_does_not_backprop_into_backbone``)."""
    np.random.seed(0)
    pcfg, pb = _port(training=True)
    ds = build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, training=True)
    batch = pb.to_device(ds.collate_batch([ds[0], ds[1]]))
    pb.module.train(True)
    out = pb.module(batch)
    loss, _ = second_head.second_head_loss(out, batch["gt_boxes"])
    loss.backward()
    for name, p in pb.module.named_parameters():
        if name.startswith("roi_head"):
            continue
        assert p.grad is None or not p.grad.any(), name
    assert any(p.grad.abs().max() > 0 for p in pb.module.roi_head.parameters())


@pytest.fixture(scope="module")
def train():
    """JAX's three steps from flax's initial values on one augmented batch
    (its step-1 gradients from the same compiled value-and-gradient), its
    predictions under both rescorings, and the port's steps and
    predictions from the same weights."""
    np.random.seed(0)
    jcfg = tiny(j_cfg_from_yaml_file(CFG, JEDict()))
    jds, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                         training=True)
    batch = next(iter(jloader))
    arrays = {k: jnp.asarray(v) for k, v in j_train_utils.select_batch_arrays(batch).items()}
    jb = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=jds)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jb.module.init(
        {"params": key, "sampling": key, "dropout": key}, b, training=False), arrays)
    tree = flax_init_tree(random_tree(dict(shapes), np.random.RandomState(1)))
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])
    tx, _ = j_optimization.build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
    state = j_train_utils.TrainState.create(apply_fn=jb.module.apply, params=params, tx=tx,
                                            batch_stats=stats)
    step_batch = dict(arrays, batch_size=2)

    @jax.jit
    def value_and_grad(p, s):
        def loss_fn(p):
            total, (tb, new_state) = jb.loss({"params": p, "batch_stats": s}, step_batch)
            return total, (tb, new_state)

        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    @jax.jit
    def apply_gradients(state, grads, new_stats):
        return state.apply_gradients(grads=grads).replace(batch_stats=new_stats)

    @jit_o0
    def predict(variables):
        out = jb.module.apply(variables, arrays, training=False)
        dets = {}
        for score_type in SCORE_TYPES:
            jb.post_cfg["SCORE_TYPE"] = score_type
            dets[score_type] = jb.post_processing(out)
        return dets

    jlosses, jgrads = [], None
    for _ in range(STEPS):
        (loss, (tb, new_state)), grads = value_and_grad(state.params, state.batch_stats)
        jgrads = grads if jgrads is None else jgrads
        state = apply_gradients(state, grads, new_state["batch_stats"])
        jlosses.append({**{k: float(v) for k, v in tb.items()}, "loss": float(loss)})
    final = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    jdets = jax.device_get(predict({"params": state.params, "batch_stats": state.batch_stats}))

    port = {fused: _port_steps(fused, tree, batch, steps) for fused, steps in ((False, STEPS),
                                                                              (True, 1))}
    pb = port[False]["bundle"]
    pout = pb.forward(pb.to_device(batch))
    pdets = {}
    for score_type in SCORE_TYPES:
        pb.post_cfg["SCORE_TYPE"] = score_type
        pdets[score_type] = {k: v.numpy() for k, v in pb.post_processing(pout).items()}
    return dict(jlosses=jlosses, port=port, jdets=jdets, pdets=pdets,
                jgrads=state_dict_from_flax({"params": jax.device_get(jgrads)}, pb.module),
                jfinal=state_dict_from_flax(final, pb.module))


def _port_steps(fused, tree, batch, steps):
    """``steps`` port ``make_train_step`` steps from the flax ``tree`` on
    either conv contract: losses, step-1 gradients, the initial and final
    state dicts, the steps' summed LR and the bundle."""
    pcfg, pb = _port(training=True, fused=fused)
    assert len(pb.anchors) == ANCHORS
    init = state_dict_from_flax(tree, pb.module)
    pb.module.load_state_dict(init, strict=True)
    pstate, _ = train_utils.create_train_state(pb, pcfg.OPTIMIZATION, TOTAL_STEPS)
    pstep = train_utils.make_train_step(pb)
    losses, grads = [], None
    for _ in range(steps):
        pstate, tb = pstep(pstate, batch)
        losses.append({k: float(v) for k, v in tb.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in pb.module.named_parameters()}
    return dict(losses=losses, grads=grads, init=init, final=pb.module.state_dict(), bundle=pb,
                lr_sum=sum(pstate.lr_fn(s) for s in range(steps)))


def test_three_step_losses_equal_jax(train):
    """Each loss term of each step, the IoU loss among them, to 1e-3
    relative (the fused contract's first step too); ``rpn_loss`` is the
    total, as in JAX."""
    for j, p in zip(train["jlosses"], train["port"][False]["losses"]
                    + train["port"][True]["losses"]):
        assert set(j) == set(p) == {"loss", "rpn_loss", "rpn_loss_cls", "rpn_loss_loc",
                                    "rpn_loss_dir", "rcnn_loss_iou"}
        for k in j:
            assert abs(p[k] - j[k]) <= 1e-3 * abs(j[k]), (k, p[k], j[k])
        assert p["rpn_loss"] == p["loss"] and p["rcnn_loss_iou"] > 0


def test_step1_gradients_equal_jax(train):
    """Every parameter's step-1 gradient, the head's FCs among them, to 1e-3
    of its largest |gradient|, on either conv contract of the backbone."""
    jg = train["jgrads"]
    assert any(k.startswith("roi_head.shared_fc_0") for k in jg)
    for fused in (False, True):
        pg = train["port"][fused]["grads"]
        assert set(jg) == set(pg)
        for name, want in jg.items():
            scale = max(float(want.abs().max()), 1e-12)
            assert float((pg[name] - want).abs().max()) <= 1e-3 * scale, (fused, name)


def test_params_and_running_stats_after_three_steps_equal_jax(train):
    """The updates as ``chip_smoke.update_mismatches`` holds them, the
    BatchNorm running statistics to 1e-4, every parameter moved."""
    port = train["port"][False]
    jf, pf, init = train["jfinal"], port["final"], port["init"]
    assert update_mismatches(pf, jf, init, train["jgrads"], port["lr_sum"])[0] == []
    for name, want in jf.items():
        got = pf[name].float()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        elif not name.endswith("num_batches_tracked"):
            assert not torch.equal(got, init[name]), name


@pytest.mark.parametrize("score_type", SCORE_TYPES)
def test_predict_rescoring_keeps_jax_detections(train, score_type):
    """After the three steps, ``predict``'s RoIs (as sets: anchors whose
    scores tie within rounding may swap places in the ranking) rescored by
    the IoU head (with the per-RoI point count for num_pts_iou_cls) and
    through the NMS keep JAX's boxes, scores and labels, in any order."""
    jd, pd = train["jdets"][score_type], train["pdets"][score_type]
    for b in range(pd["pred_mask"].shape[0]):
        np.testing.assert_allclose(*(r[np.lexsort(r.T[::-1])] for r in
                                     (pd["rois"][b], np.asarray(jd["rois"][b]))),
                                   rtol=1e-4, atol=1e-4)
        jm, pm = np.asarray(jd["pred_mask"][b]), pd["pred_mask"][b]
        assert jm.sum() == pm.sum() > 0

        def rows(d, m):
            r = np.concatenate([np.asarray(d["pred_boxes"][b])[m],
                                np.asarray(d["pred_scores"][b])[m, None],
                                np.asarray(d["pred_labels"][b])[m, None]], 1)
            return r[np.lexsort(r.T[::-1])]

        np.testing.assert_allclose(rows(pd, pm), rows(jd, jm), rtol=1e-4, atol=1e-4)
