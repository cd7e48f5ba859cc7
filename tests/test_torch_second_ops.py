"""SECOND's ops: the PyTorch port against the JAX package, on the CPU.

The column gathers of the transposed layout, K8 (``gather_rows_taps_t``)
and K7 (``gather9_stacked_t``, both row orders, the identity tap): their
plain versions against JAX's Pallas kernels in interpret mode and against
its XLA fallbacks, in f32 and bf16, exactly (gathers are copies). The conv
of the transposed layout, ``pillar_conv3d_t``, forward and gradients against
JAX's custom VJP on each of its paths. The anchor head's training pieces:
the axis-aligned target assigner (labels integer-equal), the box encode and
the losses on fixed boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jit_o0, vjp_o0

from toda_tpu.models.dense_heads import anchor_head_single as j_head
from toda_tpu.models.dense_heads.target_assigner.anchor_generator import (
    AnchorGenerator as JAnchorGenerator,
)
from toda_tpu.models.dense_heads.target_assigner.axis_aligned_target_assigner import (
    AxisAlignedTargetAssigner as JAssigner,
)
from toda_tpu.ops import pallas_gather as pg
from toda_tpu.ops import pillar_sparse as jps
from toda_tpu.utils.box_coder_utils import ResidualCoder as JCoder
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.models.dense_heads.anchor_head_single import anchor_head_loss
from toda_tpu_torch.models.dense_heads.target_assigner.anchor_generator import AnchorGenerator
from toda_tpu_torch.models.dense_heads.target_assigner.axis_aligned_target_assigner import (
    AxisAlignedTargetAssigner,
)
from toda_tpu_torch.ops import gather
from toda_tpu_torch.ops.pillar_sparse import pillar_conv3d_t
from toda_tpu_torch.utils.box_coder_utils import ResidualCoder

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/second_synthetic.yaml"
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tables(rng, w=32, n=512, m=512, miss=0.2):
    """A (W, N) table without zeros and (M, 9) monotone tap indices as the
    key-sorted pillar sets give them (each dy group within a few columns
    of its block), -1 where missing."""
    table = rng.uniform(0.5, 2.0, (w, n)) * rng.choice([-1.0, 1.0], (w, n))
    base = np.sort(np.clip(np.arange(m) + rng.randint(-2, 3, size=m), 40, n - 40))
    idx = np.stack([np.clip(base + d, 0, n - 1) for d in
                    (-33, -32, -31, -1, 0, 1, 31, 32, 33)], axis=1).astype(np.int32)
    idx[rng.rand(m, 9) < miss] = -1
    return table.astype(np.float32), idx


def _same(got, want):
    """Exact equality of a port tensor and a JAX array, in f32."""
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, dtype=np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k8_plain_equals_jax_fallback(dtype):
    """K8's plain version against JAX's XLA fallback, for each dy group's
    taps (the centre group without its identity tap, as the convs call it)."""
    _, jdt, tdt = DTYPES[dtype]
    table, idx = _tables(np.random.RandomState(1))
    tt = torch.from_numpy(table).to(tdt)
    for grp in ((0, 1, 2), (3, 5), (6, 7, 8)):
        sub = np.ascontiguousarray(idx[:, grp])
        got = gather.gather_rows_taps_t(tt, torch.from_numpy(sub))
        assert got.shape == (len(grp), table.shape[0], sub.shape[0]) and got.dtype == tdt
        for t, want in enumerate(pg.gather_rows_taps_t(jnp.asarray(table, jdt),
                                                       jnp.asarray(sub))):
            _same(got[t], want)


def test_k8_plain_equals_jax_interpret_kernel(monkeypatch):
    """K8's plain version against JAX's ``_gather_taps_t_kernel`` in
    interpret mode, in bf16 (the kernel's type on the TPU)."""
    table, idx = _tables(np.random.RandomState(1))
    sub = np.ascontiguousarray(idx[:, :3])
    got = gather.gather_rows_taps_t(torch.from_numpy(table).to(torch.bfloat16),
                                    torch.from_numpy(sub))
    monkeypatch.setattr(pg, "INTERPRET", True)
    meta, li4, overflow = pg._taps_t_prologue(jnp.asarray(sub), table.shape[1], pg.SPAN_T)
    assert not bool(overflow)
    kernel = jit_o0(lambda *a: pg._pallas_gather_taps_t(*a, sub.shape[0], 3, pg.SPAN_T))(
        jnp.asarray(table, jnp.bfloat16), meta, li4)
    for t, want in enumerate(kernel):
        _same(got[t], want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk", [None, 8])
def test_k7_plain_equals_jax_fallback(dtype, chunk):
    """K7's plain version against JAX's XLA fallback in both row orders, the
    identity tap's column included (there the table holds the column's own
    index, so copying and gathering agree)."""
    _, jdt, tdt = DTYPES[dtype]
    table, idx = _tables(np.random.RandomState(2))
    idx[:, 4] = np.arange(idx.shape[0])
    got = gather.gather9_stacked_t(torch.from_numpy(table).to(tdt), torch.from_numpy(idx),
                                   chunk=chunk, identity_tap=4)
    assert got.shape == (9 * table.shape[0], idx.shape[0]) and got.dtype == tdt
    _same(got, pg.gather9_stacked_t(jnp.asarray(table, jdt), jnp.asarray(idx), chunk=chunk,
                                    identity_tap=4))


def test_k7_plain_equals_jax_interpret_kernel(monkeypatch):
    """K7's plain version against JAX's ``_gather9_stacked_kernel`` in
    interpret mode, in bf16 (the kernel's type on the TPU), in the
    chunk-interleaved row order (the [t][W] order runs through the kernel
    in the stacked conv's test below). The identity tap's table column is
    -1 on the invalid rows and the table's invalid columns are not zero:
    the kernel copies the table's own column there, and so does the port
    (JAX's XLA fallback would write zeros, and the test shows that it
    differs)."""
    jdt, tdt, chunk, identity = jnp.bfloat16, torch.bfloat16, 8, 4
    table, idx = _tables(np.random.RandomState(3))
    m = idx.shape[0]
    invalid = np.zeros(m, bool)
    invalid[-24:] = True
    idx[invalid] = -1
    idx[~invalid, 4] = np.nonzero(~invalid)[0]
    tj, ij = jnp.asarray(table, jdt), jnp.asarray(idx)
    got = gather.gather9_stacked_t(torch.from_numpy(table).to(tdt), torch.from_numpy(idx),
                                   chunk=chunk, identity_tap=identity)
    monkeypatch.setattr(pg, "INTERPRET", True)
    meta, li4, overflow = pg._stacked_prologue(ij, table.shape[1], pg.SPAN_T)
    assert not bool(overflow)
    want = jit_o0(lambda t_, me, li: pg._pallas_gather9_stacked(t_, me, li, m, pg.SPAN_T, chunk,
                                                                identity, t_))(tj, meta, li4)
    _same(got, want)
    monkeypatch.setattr(pg, "INTERPRET", False)
    fallback = np.asarray(pg.gather9_stacked_t(tj, ij, chunk=chunk, identity_tap=identity),
                          dtype=np.float32)
    assert not np.array_equal(got.float().numpy(), fallback)


def _pillar_set(rng, p, ny=64, nx=64, empty=20):
    keys = np.sort(rng.choice(ny * nx, size=p - empty, replace=False))
    coords = np.full((p, 2), -1, np.int32)
    coords[:p - empty, 0], coords[:p - empty, 1] = keys // nx, keys % nx
    mask = np.zeros(p, bool)
    mask[:p - empty] = True
    return coords, mask


def _conv_case(z_stride, c, cout, seed=21, p=512, nz=4):
    """Inputs of one ``pillar_conv3d_t`` call, with JAX's tables: the
    submanifold table and its mirrored inverse (stride 1), or the stride-2
    table onto the downsampled sites and its inverse."""
    rng = np.random.RandomState(seed)
    coords, mask = _pillar_set(rng, p)
    cj, mj = jnp.asarray(coords), jnp.asarray(mask)
    if z_stride == 1:
        nbr = np.asarray(jps.bev_neighbor_idx_sorted(cj, mj, cj, mj, (64, 64), 1))
        inv, out_mask = nbr[:, ::-1].copy(), mask
    else:
        oc, om = jps.bev_downsample_sites(cj, mj, 2, p // 2, (64, 64))
        nbr = np.asarray(jps.bev_neighbor_idx_sorted(cj, mj, oc, om, (64, 64), 2))
        inv = np.array(jps.bev_inv_neighbor_idx_sorted(oc, om, cj, mj, (32, 32)))
        out_mask = np.array(om)
    feats = (rng.randn(nz, c, p) * mask).astype(np.float32).reshape(nz * c, p)
    w = (rng.randn(3, 3, 3, c, cout) * 0.2).astype(np.float32)
    nz_out = -(-nz // z_stride)
    ct = rng.randn(nz_out * cout, nbr.shape[0]).astype(np.float32)
    return dict(flatT=feats, idx=nbr.astype(np.int32), inv=inv.astype(np.int32), w=w,
                mask=out_mask, ct=ct, nz=nz, z_stride=z_stride,
                identity=4 if z_stride == 1 else None)


CONV_CASES = {
    # stride 1, C % 16 == 0: K7 forward (identity tap), K7 backward (chunk Cout)
    "stacked": (1, 16, 16),
    # C = 8, the padded first layer: K8 forward per dy group, K7 backward
    "grouped_c8": (1, 8, 16),
    # stride 2 (a down conv): K8 forward, K7 backward through the inverse table
    "stride2": (2, 16, 32),
    # Cout % 16 != 0: K7 forward, K8 backward per dy group
    "cout8": (1, 16, 8),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_pillar_conv3d_t_forward_and_gradients_equal_jax(case, monkeypatch):
    """Output, input and weight cotangents of one conv in f32 against JAX's
    ``pillar_conv3d_t``, to rtol 1e-5 plus 1e-5 of each tensor's largest
    magnitude. The stacked case runs JAX's Pallas gathers in interpret
    mode (forward and backward through K7's TPU kernel); the others its
    XLA gathers (the kernels' plain reference), since the gathers
    themselves are held to the interpret-mode kernels above."""
    k = _conv_case(*CONV_CASES[case])
    monkeypatch.setattr(pg, "INTERPRET", case == "stacked")

    def jconv(x, w):
        return jps.pillar_conv3d_t(x, jnp.asarray(k["idx"]), w, jnp.asarray(k["mask"]), k["nz"],
                                   k["z_stride"], k["identity"], jnp.asarray(k["inv"]))

    jout, (jdx, jdw) = vjp_o0(jconv, (jnp.asarray(k["flatT"]), jnp.asarray(k["w"])),
                              jnp.asarray(k["ct"]))

    x = torch.from_numpy(k["flatT"]).requires_grad_()
    w = torch.from_numpy(k["w"]).requires_grad_()
    out = pillar_conv3d_t(x, torch.from_numpy(k["idx"]), w, torch.from_numpy(k["mask"]), k["nz"],
                          k["z_stride"], k["identity"], torch.from_numpy(k["inv"]))
    out.backward(torch.from_numpy(k["ct"]))
    for name, got, want in (("out", out, jout), ("dx", x.grad, jdx), ("dw", w.grad, jdw)):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert np.abs(np.asarray(jdx)).max() > 0


# ------------------------------------------ the anchor head's training pieces


def _anchor_setup():
    cfg = cfg_from_yaml_file(CFG, EDict())
    gen_cfg = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    args = ([-16.0, -16.0, -3.0, 16.0, 16.0, 1.0], (64, 64, 8))
    return cfg, AnchorGenerator(gen_cfg, *args).generate(), \
        JAnchorGenerator(gen_cfg, *args).generate()


def _gt_boxes(anchors, rng):
    """(2, 6, 8) gt boxes: some on anchors (matched), some between anchor
    sizes (force-matched or ignored), both classes, padding rows."""
    gt = np.zeros((2, 6, 8), np.float32)
    for b in range(2):
        picks = rng.choice(len(anchors), 4, replace=False)
        for i, a in enumerate(anchors[picks]):
            gt[b, i, :7] = a
            gt[b, i, :2] += rng.uniform(-0.8, 0.8, 2)
            gt[b, i, 3:6] *= rng.uniform(0.7, 1.3, 3)
            gt[b, i, 6] += rng.uniform(-0.5, 0.5)
            gt[b, i, 7] = 1 + (a[3] < 2.0)  # car anchors are the long ones
    gt[1, 4] = [3.1, -2.2, -0.9, 2.5, 1.2, 1.5, 0.3, 1]  # between sizes
    return gt


@pytest.fixture(scope="module")
def targets():
    cfg, (anchors, cls, m, u, _), jgen = _anchor_setup()
    janchors, jcls, jm, ju = jgen[:4]
    for got, ref in ((anchors, janchors), (cls, jcls), (m, jm), (u, ju)):
        np.testing.assert_array_equal(got, ref)
    gt = _gt_boxes(anchors, np.random.RandomState(4))
    want = jit_o0(JAssigner(janchors, jcls, jm, ju, JCoder()).assign)(jnp.asarray(gt))
    got = AxisAlignedTargetAssigner(
        torch.from_numpy(anchors), torch.from_numpy(cls), torch.from_numpy(m),
        torch.from_numpy(u), ResidualCoder()).assign(torch.from_numpy(gt))
    return cfg, anchors, gt, got, jax.device_get(want)


def test_assigner_equals_jax(targets):
    """Labels integer-equal (positives, force matches and ignored anchors
    all present); regression targets, weights and headings to 1e-6."""
    _, _, _, got, want = targets
    labels = got["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, want["box_cls_labels"])
    assert (labels == 1).any() and (labels == 2).any() and (labels == -1).any()
    for k in ("box_reg_targets", "reg_weights", "matched_gt_heading"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_encode_equals_jax_and_inverts_decode(targets):
    _, anchors, gt, _, _ = targets
    boxes = np.repeat(gt[0, :4, :7], len(anchors) // 4, axis=0)[:len(anchors)]
    got = ResidualCoder().encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
    want = np.asarray(JCoder().encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = ResidualCoder().decode(got, torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(back, boxes, rtol=1e-5, atol=1e-5)


def test_anchor_head_losses_equal_jax(targets):
    """Focal class, sin-difference smooth-L1 and direction losses on random
    head outputs and the assigner's targets, to 1e-6 relative."""
    cfg, anchors, _, got, want = targets
    rng = np.random.RandomState(5)
    n = len(anchors)
    out = {"cls_preds": rng.normal(0, 2, (2, n, 2)), "box_preds": rng.normal(0, 0.5, (2, n, 7)),
           "dir_cls_preds": rng.normal(0, 1, (2, n, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    head_cfg = cfg.MODEL.DENSE_HEAD
    jtotal, jtb = jit_o0(lambda o, w: j_head.anchor_head_loss(
        dict(o, batch_size=2), w, None, head_cfg, 2, JCoder()))(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in want.items()})
    total, tb = anchor_head_loss({k: torch.from_numpy(v) for k, v in out.items()}, got,
                                 head_cfg, 2)
    assert set(tb) == set(jtb) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss"}
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= 1e-6 * abs(float(jtb[k])), k
    assert abs(float(total) - float(jtotal)) <= 1e-6 * abs(float(jtotal))


def test_world_flip_along_x_and_y_equals_jax_and_replays():
    """``random_world_flip`` along x and y (the Waymo augmentor list): the
    same draws under the same numpy seed as JAX's augmentor, the same boxes
    and points, each flip recorded, and a recorded sequence replayed."""
    from toda_tpu.config import EDict as JEDict
    from toda_tpu.datasets.augmentor.data_augmentor import DataAugmentor as JAugmentor
    from toda_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor

    aug_cfg = [{"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]}]
    rng = np.random.RandomState(6)
    boxes = rng.randn(5, 9).astype(np.float32)
    points = rng.randn(40, 5).astype(np.float32)
    port = DataAugmentor(None, [EDict(c) for c in aug_cfg], ["car"])
    ref = JAugmentor(None, [JEDict(c) for c in aug_cfg], ["car"])
    flips = set()
    for seed in range(8):
        out = []
        for aug in (port, ref):
            np.random.seed(seed)
            out.append(aug.forward({"gt_boxes": boxes.copy(), "points": points.copy()}))
        (p, j) = out
        np.testing.assert_array_equal(p["points"], j["points"])
        np.testing.assert_allclose(p["gt_boxes"], j["gt_boxes"], rtol=1e-6, atol=1e-6)
        assert [n for n, _ in p["augmentation_params"]] == ["random_world_flip_x",
                                                             "random_world_flip_y"]
        assert p["augmentation_params"] == j["augmentation_params"]
        flips.add(tuple(bool(v) for _, v in p["augmentation_params"]))
        again = port.forward({"gt_boxes": boxes.copy(), "points": points.copy(),
                              "replay_params": p["augmentation_params"]})
        np.testing.assert_array_equal(again["points"], p["points"])
        np.testing.assert_array_equal(again["gt_boxes"], p["gt_boxes"])
    assert (False, True) in flips and (True, True) in flips
