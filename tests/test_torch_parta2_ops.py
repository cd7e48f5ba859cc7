"""The PartA2 slice's ops and pure functions: the PyTorch port against the
JAX package on the same numpy inputs.

K9 (``gather_rows_taps``, through its plain version, which is what a CPU
tensor runs) against the TPU kernel in Pallas interpret mode and against
JAX's fallback, exactly; the row-major sparse convs in f32; UNetV2's three
kinds of neighbour table, integer for integer; RoI-aware pooling with points
on cell boundaries and an empty RoI; and the anchor head's, proposal layer's
and RoI head's decode functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jit_o0

from toda_tpu.models.dense_heads import anchor_head_single as j_anchor_head
from toda_tpu.models.dense_heads.target_assigner.anchor_generator import \
    AnchorGenerator as JAnchorGenerator
from toda_tpu.models.roi_heads import roi_utils as j_roi_utils
from toda_tpu.ops import pallas_gather as pg
from toda_tpu.ops import pillar_sparse as jps
from toda_tpu.ops.roi_pool3d import roiaware_pool3d as j_roiaware_pool3d
from toda_tpu.runtime import eval_utils as j_eval
from toda_tpu.utils.box_coder_utils import ResidualCoder as JResidualCoder
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.models.dense_heads import anchor_head_single
from toda_tpu_torch.models.dense_heads.target_assigner.anchor_generator import AnchorGenerator
from toda_tpu_torch.models.roi_heads import roi_utils
from toda_tpu_torch.ops import gather, pillar_sparse
from toda_tpu_torch.ops.roi_pool3d import roiaware_pool3d
from toda_tpu_torch.runtime import eval_utils
from toda_tpu_torch.utils.box_coder_utils import ResidualCoder

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/parta2_synthetic.yaml"


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------------ K9


def _taps_case(ntap, dtype, n=1024, m=512, w=48, seed=0):
    """A table and an (M, T) table of per-tap monotone indices (each tap a
    constant offset of one sorted stream, as a dy group's taps are), 20%
    -1, every block's span inside the TPU kernel's window."""
    rng = np.random.RandomState(seed)
    table = rng.randn(n, w).astype(np.float32)
    base = np.sort(np.clip(np.arange(m) + rng.randint(-3, 4, m) + n // 4, 0, n - 1 - ntap))
    idx = base[:, None] + np.arange(ntap)[None]
    idx = np.where(rng.rand(m, ntap) < 0.2, -1, idx).astype(np.int32)
    tj = jnp.asarray(table).astype(dtype)
    return tj, idx, t(np.asarray(tj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("ntap", [2, 3])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_gather_rows_taps_matches_pallas_interpret_and_fallback(monkeypatch, ntap, dtype):
    """K9 plain vs the TPU kernel in interpret mode and vs toda_tpu's
    gather_rows_taps (its XLA fallback on the CPU): exact."""
    tj, idx, table = _taps_case(ntap, dtype)
    got = gather.gather_rows_taps(table, t(idx)).float().numpy()
    assert got.shape == (ntap, idx.shape[0], table.shape[1])
    assert (idx < 0).any() and not got[0][idx[:, 0] < 0].any()
    fallback = pg.gather_rows_taps(tj, jnp.asarray(idx))
    lo, li, overflow = pg._taps_prologue(jnp.asarray(idx), tj.shape[0])
    assert not bool(overflow)
    monkeypatch.setattr(pg, "INTERPRET", True)
    kernel = jit_o0(lambda *a: pg._pallas_gather_taps(*a, idx.shape[0], ntap))(tj, lo, li)
    for k in range(ntap):
        np.testing.assert_array_equal(got[k], np.asarray(fallback[k].astype(jnp.float32)))
        np.testing.assert_array_equal(got[k], np.asarray(kernel[k].astype(jnp.float32)))


# --------------------------------------------------------------- convs, tables

BEV = (20, 20)


def _pillars(rng, bt=2, p=200, counts=(150, 120)):
    coords = np.full((bt, p, 2), -1, np.int32)
    for b, n in enumerate(counts):
        keys = np.sort(rng.choice(BEV[0] * BEV[1], n, replace=False))
        coords[b, :n, 0], coords[b, :n, 1] = keys // BEV[1], keys % BEV[1]
    return coords, coords[..., 0] >= 0


@pytest.fixture(scope="module")
def sites():
    """Two samples of fine pillars, their stride-2 sites and the three
    kinds of table from both packages."""
    coords, mask = _pillars(np.random.RandomState(5))
    jc, jm = jnp.asarray(coords), jnp.asarray(mask)
    oc, om = pillar_sparse.bev_downsample_sites(t(coords), t(mask), 2, 100, BEV)
    joc, jom = jnp.asarray(oc.numpy()), jnp.asarray(om.numpy())
    coarse = (BEV[0] // 2, BEV[1] // 2)
    bmap = jax.vmap(lambda c, m: jps.build_bev_map(c, m, BEV))(jc, jm)
    return dict(
        coords=coords, mask=mask, oc=oc, om=om,
        subm=pillar_sparse.bev_neighbor_idx_sorted_batched(t(coords), t(mask), t(coords),
                                                           t(mask), BEV, 1),
        jsubm=jax.vmap(lambda c, m, bm: jps.bev_neighbor_idx(c, m, bm, BEV, 1))(jc, jm, bmap),
        down=pillar_sparse.bev_neighbor_idx_sorted_batched(t(coords), t(mask), oc, om, BEV, 2),
        jdown=jps.bev_neighbor_idx_sorted_batched(jc, jm, joc, jom, BEV, 2),
        inv=pillar_sparse.bev_inv_down_idx_batched(oc, om, t(coords), t(mask), coarse),
        jinv=jps.bev_inv_neighbor_idx_sorted_batched(joc, jom, jc, jm, coarse))


def test_unet_tables_equal_jax(sites):
    """The sorted lookups give UNetV2's tables integer for integer, -1s
    included: the submanifold table of build_bev_map + bev_neighbor_idx,
    the stride-2 table and the decoder's inverse table."""
    for port, ref in (("subm", "jsubm"), ("down", "jdown"), ("inv", "jinv")):
        got, want = sites[port].numpy(), np.asarray(sites[ref])
        np.testing.assert_array_equal(got, want, err_msg=port)
        assert (got >= 0).any() and (got < 0).any(), port


@pytest.mark.parametrize("kind", ["subm", "down"])
def test_pillar_conv3d_matches_jax_f32(sites, kind):
    """Stride 1 with identity tap 4, and stride 2 over an odd nz (5 -> 3)."""
    rng = np.random.RandomState(6)
    bt, p, nz, c, cout = 2, 200, 5, 4, 6
    x = rng.randn(bt, p, nz, c).astype(np.float32) * sites["mask"][..., None, None]
    w = rng.randn(3, 3, 3, c, cout).astype(np.float32)
    stride, tap, out_mask = (1, 4, t(sites["mask"])) if kind == "subm" else (2, None, sites["om"])
    nbr = sites[kind]
    ref = np.asarray(jit_o0(lambda *a: jps.pillar_conv3d(*a, stride, tap))(
        jnp.asarray(x), jnp.asarray(nbr.numpy()), jnp.asarray(w), jnp.asarray(out_mask.numpy())))
    got = pillar_sparse.pillar_conv3d(t(x).reshape(bt * p, nz, c),
                                      pillar_sparse.fold_idx(nbr, p), t(w),
                                      out_mask.reshape(-1), stride, tap)
    np.testing.assert_allclose(got.reshape(ref.shape).numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(ref).max() > 1


def test_pillar_inv_conv3d_matches_jax_f32(sites):
    rng = np.random.RandomState(7)
    bt, pc, nzc, nzf, c, cout = 2, 100, 3, 5, 4, 6
    x = rng.randn(bt, pc, nzc, c).astype(np.float32)
    w = rng.randn(3, 3, 3, c, cout).astype(np.float32)
    ref = np.asarray(jit_o0(lambda *a: jps.pillar_inv_conv3d(*a, nzf))(
        jnp.asarray(x), sites["jinv"], jnp.asarray(w), jnp.asarray(sites["mask"])))
    got = pillar_sparse.pillar_inv_conv3d(t(x).reshape(bt * pc, nzc, c),
                                          pillar_sparse.fold_idx(sites["inv"], pc), t(w),
                                          t(sites["mask"]).reshape(-1), nzf)
    np.testing.assert_allclose(got.reshape(ref.shape).numpy(), ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- RoI pooling


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(pool):
    """Random points and rotated RoIs, points exactly on the cell
    boundaries (and on the far faces) of an axis-aligned RoI whose cell
    sizes are powers of two, masked points, and an empty RoI."""
    rng = np.random.RandomState(8)
    g = 4
    grid = np.stack(np.meshgrid(np.arange(-1, 1.01, 0.5), np.arange(-0.5, 0.51, 0.25),
                                np.arange(-0.25, 0.26, 0.125), indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([grid + [3.0, -2.0, 0.5], rng.uniform(-4, 4, (600, 3))]).astype(np.float32)
    feats = rng.randn(len(pts), 5).astype(np.float32)
    mask = rng.rand(len(pts)) > 0.1
    mask[:len(grid)] = True
    rois = np.array([[3.0, -2.0, 0.5, 2.0, 1.0, 0.5, 0.0],
                     [0.5, 0.5, 0.0, 3.0, 2.0, 2.0, 0.7],
                     [-1.0, 2.0, 0.5, 4.0, 1.5, 1.0, -2.3],
                     [40.0, 40.0, 0.0, 2.0, 2.0, 2.0, 0.3]], np.float32)
    ref, _ = j_roiaware_pool3d(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(mask),
                               jnp.asarray(rois), out_size=g, pool=pool)
    got = roiaware_pool3d(t(pts), t(feats), t(mask), t(rois), out_size=g, pool=pool)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert not got[3].any() and (got[0] != 0).sum() > 0


# ------------------------------------------------------- heads' pure functions


def _cfg():
    return cfg_from_yaml_file(CFG, EDict())


def test_anchors_equal_jax():
    cfg = _cfg()
    gen_cfg = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    args = ([-20.0, -20.0, -3.0, 20.0, 20.0, 1.0], (128, 128, 16))
    anchors, cls, matched, unmatched, per_loc = AnchorGenerator(gen_cfg, *args).generate()
    want = JAnchorGenerator(gen_cfg, *args).generate()
    for got, ref in zip((anchors, cls, matched, unmatched), want):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert per_loc == want[5] == 4 and anchors.shape == (16 * 16 * 4, 7)


def _anchor_outputs(rng, b=2, n=300, nc=2):
    anchors = np.concatenate([rng.uniform(-10, 10, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                              rng.uniform(-3, 3, (n, 1))], 1).astype(np.float32)
    out = {"box_preds": rng.normal(0, 0.3, (b, n, 7)).astype(np.float32),
           "cls_preds": rng.normal(0, 2, (b, n, nc)).astype(np.float32),
           "dir_cls_preds": rng.normal(0, 1, (b, n, 2)).astype(np.float32)}
    return anchors, out


def test_box_decode_and_predicted_boxes_match_jax():
    """ResidualCoder.decode and the anchor head's decode with the direction
    classifier."""
    anchors, out = _anchor_outputs(np.random.RandomState(9))
    cfg = _cfg().MODEL.DENSE_HEAD
    np.testing.assert_allclose(
        ResidualCoder().decode(t(out["box_preds"]), t(anchors)[None]).numpy(),
        np.asarray(JResidualCoder().decode(jnp.asarray(out["box_preds"]),
                                           jnp.asarray(anchors)[None])), rtol=1e-5, atol=1e-5)
    jcls, jboxes = jit_o0(lambda o, a: j_anchor_head.generate_predicted_boxes(
        o, a, cfg, JResidualCoder()))({k: jnp.asarray(v) for k, v in out.items()},
                                      jnp.asarray(anchors))
    cls, boxes = anchor_head_single.generate_predicted_boxes(
        {k: t(v) for k, v in out.items()}, t(anchors), cfg, ResidualCoder())
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-5, atol=1e-5)


def test_proposal_layer_matches_jax():
    """The kept proposals (a set: boxes, scores, labels) and the masks."""
    anchors, out = _anchor_outputs(np.random.RandomState(10), n=400)
    boxes = np.asarray(JResidualCoder().decode(jnp.asarray(out["box_preds"]),
                                               jnp.asarray(anchors)[None]))
    nms_cfg = _cfg().MODEL.ROI_HEAD.NMS_CONFIG.TEST
    jr = jit_o0(lambda b_, c_: j_roi_utils.proposal_layer(b_, c_, nms_cfg))(
        jnp.asarray(boxes), jnp.asarray(out["cls_preds"]))
    pr = roi_utils.proposal_layer(t(boxes), t(out["cls_preds"]), nms_cfg)
    for b in range(boxes.shape[0]):
        jm, pm = np.asarray(jr[3][b]), pr[3][b].numpy()
        assert jm.sum() == pm.sum() > 0
        rows_j = np.concatenate([np.asarray(jr[0][b])[jm], np.asarray(jr[1][b])[jm, None],
                                 np.asarray(jr[2][b])[jm, None]], 1)
        rows_p = np.concatenate([pr[0][b].numpy()[pm], pr[1][b].numpy()[pm, None],
                                 pr[2][b].numpy()[pm, None]], 1)
        order_j, order_p = np.lexsort(rows_j.T[::-1]), np.lexsort(rows_p.T[::-1])
        np.testing.assert_allclose(rows_p[order_p], rows_j[order_j], rtol=1e-6, atol=1e-6)


def test_roi_box_decode_and_roi_recall_match_jax():
    rng = np.random.RandomState(11)
    rois = np.concatenate([rng.uniform(-10, 10, (2, 30, 3)), rng.uniform(1, 4, (2, 30, 3)),
                           rng.uniform(-3, 3, (2, 30, 1))], -1).astype(np.float32)
    rcnn_cls = rng.randn(2, 30, 1).astype(np.float32)
    rcnn_reg = rng.normal(0, 0.2, (2, 30, 7)).astype(np.float32)
    _, jboxes = jit_o0(lambda *a: j_roi_utils.generate_predicted_boxes_roi(*a, JResidualCoder()))(
        jnp.asarray(rois), jnp.asarray(rcnn_cls), jnp.asarray(rcnn_reg))
    _, boxes = roi_utils.generate_predicted_boxes_roi(t(rois), t(rcnn_cls), t(rcnn_reg),
                                                      ResidualCoder())
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-5, atol=1e-5)

    gt = np.concatenate([rois[0, :8] + rng.normal(0, 0.3, (8, 7)), np.ones((8, 1))], 1)
    pred_mask, roi_mask = rng.rand(30) > 0.5, rng.rand(30) > 0.3
    args = (np.asarray(jboxes[0]), pred_mask, gt.astype(np.float32), [0.3, 0.5, 0.7])
    got = eval_utils.compute_recall(*args, rois=rois[0], roi_mask=roi_mask)
    assert got == j_eval.compute_recall(*args, rois=rois[0], roi_mask=roi_mask)
    assert got["recall_roi_0.3"] > 0
