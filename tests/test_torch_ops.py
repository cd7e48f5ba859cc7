"""The PyTorch port's ops against the JAX package on the same numpy inputs.

Covers the pillar voxelizer and its tables, the three kernel modules (K4
scatter_rows_add, K5 unpack_pillars, K1 fused_bnconv9, each through its plain
version, which is what a CPU tensor runs) against the JAX functions and their
Pallas kernels in interpret mode, and the rotated IoU / NMS. Layout helpers
convert between JAX's transposed (nz*C, M) and the port's (M, nz, C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toda_tpu.ops import nms as jnms
from toda_tpu.ops import pallas_fused_conv as pfc
from toda_tpu.ops import pallas_gather as pg
from toda_tpu.ops import pillar_sparse as jps
from toda_tpu.ops.rotated_iou import boxes_iou_bev as j_iou
from toda_tpu_torch.ops import fused_conv, gather, nms, pillar_sparse
from toda_tpu_torch.ops.rotated_iou import boxes_iou_bev

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)


def to_port(xt, nz):
    """JAX (nz*C, M) -> port (M, nz, C)."""
    xt = np.asarray(xt, np.float32)
    return xt.reshape(nz, -1, xt.shape[1]).transpose(2, 0, 1)


def t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- voxelizer


def _scan(rng, bt=2, n=2048, nmask=300):
    pts = np.concatenate([rng.uniform(-8.2, 8.2, (bt, n, 2)), rng.uniform(-2.2, 2.2, (bt, n, 1)),
                          rng.uniform(0, 1, (bt, n, 1))], axis=-1).astype(np.float32)
    mask = np.ones((bt, n), bool)
    mask[:, n - nmask:] = False
    return pts, mask


VOX = dict(voxel_size=(0.5, 0.5, 0.5), pc_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0),
           grid_size=(32, 32, 8), nz=8)


def test_voxelizer_and_tables_match_jax():
    """Pillar coords, masks and every table equal integer for integer; mean
    features agree to 1e-5 (max_pillars 256 caps the ~900 occupied pillars)."""
    max_pillars = 256
    pts, mask = _scan(np.random.RandomState(0))
    v = VOX
    ref = jax.jit(lambda p_, m_: jps.voxelize_pillars_batched(
        p_, m_, v["voxel_size"], v["pc_range"], v["grid_size"], max_pillars, v["nz"]))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = pillar_sparse.voxelize_pillars_batched(
        t(pts), t(mask), v["voxel_size"], v["pc_range"], v["grid_size"], max_pillars, v["nz"])
    coords, pmask = got["pillar_coords"], got["pillar_mask"]
    np.testing.assert_array_equal(coords.numpy(), np.asarray(ref["pillar_coords"]))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(ref["pillar_mask"]))
    x = got["x"].reshape(2, max_pillars, v["nz"], 8).numpy()
    np.testing.assert_allclose(x[..., :4], np.asarray(ref["pillar_features"]), rtol=1e-5,
                               atol=1e-5)
    assert not x[..., 4:].any()

    bev = (32, 32)
    jc, jm = ref["pillar_coords"], ref["pillar_mask"]
    np.testing.assert_array_equal(
        pillar_sparse.bev_neighbor_idx_sorted_batched(coords, pmask, coords, pmask, bev, 1).numpy(),
        np.asarray(jps.bev_neighbor_idx_sorted_batched(jc, jm, jc, jm, bev, 1)))
    p_out = max_pillars // 2
    oc, om = pillar_sparse.bev_downsample_sites(coords, pmask, 2, p_out, bev)
    joc, jom = [], []
    for b in range(2):
        c_, m_ = jps.bev_downsample_sites(jc[b], jm[b], 2, p_out, bev)
        joc.append(np.asarray(c_))
        jom.append(np.asarray(m_))
    np.testing.assert_array_equal(oc.numpy(), np.stack(joc))
    np.testing.assert_array_equal(om.numpy(), np.stack(jom))
    nbr, inv = pillar_sparse.bev_down_tables_batched(coords, pmask, oc, om, bev, (16, 16))
    jnbr, jinv = jps.bev_down_tables_batched(jc, jm, jnp.asarray(np.stack(joc)),
                                             jnp.asarray(np.stack(jom)), bev, (16, 16))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert (nbr >= 0).any() and (inv >= 0).any()


def test_pillars_to_dense_matches_jax():
    rng = np.random.RandomState(1)
    bt, p, nz, c, bev = 2, 64, 3, 4, (12, 10)
    keys = np.stack([np.sort(rng.choice(120, 50, replace=False)) for _ in range(bt)])
    coords = np.full((bt, p, 2), -1, np.int32)
    coords[:, :50, 0], coords[:, :50, 1] = keys // 10, keys % 10
    mask = coords[..., 0] >= 0
    feats = rng.randn(bt, p, nz, c).astype(np.float32)
    ref = jps.pillars_to_dense_batched(jnp.asarray(feats), jnp.asarray(coords),
                                       jnp.asarray(mask), bev)
    got = pillar_sparse.pillars_to_dense_batched(t(feats), t(coords), t(mask), bev)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------------ K4


def _sorted_idx_with_tails(rng, bt, n_per, m_per, u):
    """Per-sample nondecreasing idx (duplicates allowed) with -1 tails, folded."""
    parts = []
    for b in range(bt):
        seg = np.full((m_per,), -1, np.int32)
        seg[:u] = np.sort(rng.randint(0, n_per, u)) + b * n_per
        parts.append(seg)
    return np.concatenate(parts)


def test_scatter_rows_add_matches_jax():
    """K4 plain vs toda_tpu scatter_rows_add on the CPU (1e-5), f32 and bf16 g."""
    rng = np.random.RandomState(2)
    idx = _sorted_idx_with_tails(rng, 2, 300, 1024, 700)
    g = rng.randn(idx.size, 5).astype(np.float32)
    ref = pg.scatter_rows_add(jnp.asarray(g), jnp.asarray(idx), 600, out_dtype=jnp.float32)
    got = gather.scatter_rows_add(t(g), t(idx), 600)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    ref = pg.scatter_rows_add(gb, jnp.asarray(idx), 600, out_dtype=jnp.float32)
    got = gather.scatter_rows_add(t(np.asarray(gb.astype(jnp.float32))).bfloat16(), t(idx), 600)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_scatter_rows_add_matches_pallas_interpret(monkeypatch):
    """K4 plain vs the TPU kernel in interpret mode (1e-5)."""
    rng = np.random.RandomState(11)
    n_per, m_per, bt = 512, 1024, 2
    idx = _sorted_idx_with_tails(rng, bt, n_per, m_per, 300)
    g = rng.randn(idx.size, 128).astype(np.float32)
    n = bt * n_per
    c, tgt_win, overflow = pg._scatter_prologue(jnp.asarray(idx), n, idx.size)
    assert not bool(overflow)
    monkeypatch.setattr(pg, "INTERPRET", True)
    ref = pg._pallas_scatter(jnp.asarray(g), tgt_win, c, n, out_dtype=jnp.float32)
    got = gather.scatter_rows_add(t(g), t(idx), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------------ K5


def test_unpack_pillars_matches_jax(monkeypatch):
    """K5 plain vs unpack_pillars_t_ref and the TPU kernel (INTERPRET_FORCED),
    within one bf16 ulp, after converting the packed scatter layout."""
    rng = np.random.RandomState(3)
    bt, p, nz, c, cpad = 2, 256, 16, 4, 8
    ncell = bt * p * nz
    sums = np.zeros((ncell, c + 1), np.float32)
    sums[:, c] = rng.randint(0, 5, ncell)
    sums[:, :c] = rng.randn(ncell, c).astype(np.float32) * 3 * sums[:, c:]
    # packed layout: row r holds cells 8r..8r+7, cell g in lanes [16g, 16g+16)
    # as (hi, lo) pairs; hi carries the f32 value and lo 0
    raw = np.zeros((bt, p * nz // 8, 128), np.float32)
    cells = sums.reshape(bt, p * nz // 8, 8, c + 1)
    for g in range(8):
        for k in range(c + 1):
            raw[:, :, g * 16 + 2 * k] = cells[:, :, g, k]
    want = pg.unpack_pillars_t_ref(jnp.asarray(raw), nz, c, cpad, p)
    monkeypatch.setattr(pg, "INTERPRET_FORCED", True)
    kern = pg._unpack_impl(jnp.asarray(raw), nz, c, cpad, p)
    got = gather.unpack_pillars(t(sums), c, cpad, torch.bfloat16).float().numpy()
    got = got.reshape(bt * p, nz, cpad)
    for ref in (want, kern):
        ref = to_port(np.asarray(ref.astype(jnp.float32)), nz)
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)


# ------------------------------------------------------------------------ K1


def _sorted_coords(rng, p, ny, nx, n_active):
    keys = np.sort(rng.choice(ny * nx, size=n_active, replace=False))
    coords = np.full((p, 2), -1, np.int32)
    coords[:n_active, 0], coords[:n_active, 1] = keys // nx, keys % nx
    mask = np.zeros((p,), bool)
    mask[:n_active] = True
    return jnp.asarray(coords), jnp.asarray(mask)


def _conv_case(kind, act, seed):
    """The p=1024 subm / down scenarios of tests/test_fused_conv.py."""
    rng = np.random.default_rng(seed)
    nz, c = 5, 16
    if kind == "subm":
        ny, nx, cout = 40, 32, 16
        coords, mask = _sorted_coords(rng, 1024, ny, nx, int(1024 * 0.9))
        idx = jps.bev_neighbor_idx_sorted(coords, mask, coords, mask, (ny, nx), 1)
        inv = idx[:, ::-1]
        out_mask, stride = mask, 1
    else:
        ny, nx, cout = 48, 48, 32
        coords, mask = _sorted_coords(rng, 1024, ny, nx, int(1024 * 0.9))
        oc, out_mask = jps.bev_downsample_sites(coords, mask, 2, 1024, (ny, nx))
        idx, inv = jps.bev_down_tables(coords, mask, oc, out_mask, (ny, nx), (24, 24))
        stride = 2
    x = np.asarray(rng.standard_normal((nz * c, 1024)), np.float32) * np.asarray(mask)[None]
    w = (0.3 * rng.standard_normal((3, 3, 3, c, cout))).astype(np.float32)
    if act:
        scale = (0.5 + rng.random(c)).astype(np.float32)
        shift = (0.2 * rng.standard_normal(c)).astype(np.float32)
    else:
        scale, shift = np.ones(c, np.float32), np.zeros(c, np.float32)
    return dict(x=x, w=w, scale=scale, shift=shift, idx=np.asarray(idx),
                inv=np.ascontiguousarray(inv), mask=np.asarray(mask),
                out_mask=np.asarray(out_mask), nz=nz, stride=stride, act=act)


CASES = [("subm", True), ("subm", False), ("down", True), ("down", False)]


@pytest.mark.parametrize("kind,act", CASES)
def test_fused_bnconv9_matches_ref_fwd_f32(kind, act):
    """K1 plain vs _ref_fwd in f32 (1e-4) on every output row."""
    k = _conv_case(kind, act, seed=0)
    ref = pfc._ref_fwd(jnp.asarray(k["x"]), jnp.asarray(k["scale"]), jnp.asarray(k["shift"]),
                       jnp.asarray(k["w"]), jnp.asarray(k["idx"]), k["nz"], k["stride"], act)
    got = fused_conv.fused_bnconv9(t(to_port(k["x"], k["nz"])), t(k["scale"]), t(k["shift"]),
                                   t(k["w"]), t(k["idx"]), k["stride"], act)
    np.testing.assert_allclose(got.numpy(), to_port(ref, got.shape[1]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,act", [("subm", True), ("down", False)])
def test_fused_bnconv9_matches_pallas_interpret_bf16(monkeypatch, kind, act):
    """K1 plain vs fused_bnconv9_t's TPU kernel (interpret mode) in bf16, 0.1
    on valid output rows (the TPU kernel leaves invalid rows unspecified).
    Two cases cover both act values and both strides; interpret mode is slow."""
    monkeypatch.setattr(pfc, "INTERPRET", True)
    k = _conv_case(kind, act, seed=1)
    xb = jnp.asarray(k["x"]).astype(jnp.bfloat16)
    wb = jnp.asarray(k["w"]).astype(jnp.bfloat16)
    sb = jnp.asarray(k["scale"]).astype(jnp.bfloat16)
    hb = jnp.asarray(k["shift"]).astype(jnp.bfloat16)
    c, cout = k["w"].shape[-2], k["w"].shape[-1]
    assert pfc.fused_ok(xb.shape, xb.dtype, c, cout, k["idx"].shape[0], k["nz"], k["stride"])
    ref = pfc.fused_bnconv9_t(xb, sb, hb, wb, jnp.asarray(k["idx"]), None, k["nz"],
                              k["stride"], 4 if kind == "subm" else None, act)
    got = fused_conv.fused_bnconv9(
        t(to_port(np.asarray(xb.astype(jnp.float32)), k["nz"])).bfloat16(),
        t(np.asarray(sb.astype(jnp.float32))), t(np.asarray(hb.astype(jnp.float32))),
        t(np.asarray(wb.astype(jnp.float32))).bfloat16(), t(k["idx"]), k["stride"], act)
    m = k["out_mask"]
    np.testing.assert_allclose(got.float().numpy()[m],
                               to_port(np.asarray(ref.astype(jnp.float32)), got.shape[1])[m],
                               rtol=0.1, atol=0.1)


# ----------------------------------------------------------------- IoU / NMS


def _boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_rotated_iou_matches_jax():
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[:5] = a[:5]  # identical pairs give IoU 1
    ref = np.asarray(j_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_iou_bev(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (ref > 0.05).sum() > 10


def test_class_agnostic_nms_matches_jax():
    """Kept indices and masks equal for each frame of a batch."""
    rng = np.random.RandomState(5)
    boxes = np.stack([_boxes(rng, 96, spread=4.0) for _ in range(2)])
    scores = rng.uniform(0, 1, (2, 96)).astype(np.float32)
    idx, keep = nms.class_agnostic_nms(t(scores), t(boxes), score_thresh=0.1, nms_thresh=0.2,
                                       pre_maxsize=64, post_maxsize=40)
    for b in range(2):
        jidx, jkeep = jnms.class_agnostic_nms(jnp.asarray(scores[b]), jnp.asarray(boxes[b]),
                                              score_thresh=0.1, nms_thresh=0.2,
                                              pre_maxsize=64, post_maxsize=40)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(idx[b].numpy()[keep[b].numpy()],
                                      np.asarray(jidx)[np.asarray(jkeep)])
        assert 0 < int(keep[b].sum()) < 40
