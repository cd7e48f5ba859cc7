"""The host side of the port's column gathers (K7, K8) and of the fused
gather + stride-1 conv (K10) (``toda_tpu_torch/ops/gather.py``), on the CPU:

* ``conv_t_plan`` for every stride-1 layer of SECOND's legacy contract
  (``waymo_models/second.yaml``), the tiny SECOND and C = 8 / Cout = 8: the
  launch fits an H100 block's shared memory and its blocks and warps cover
  every output z, channel and column once;
* ``pack_conv_t_weights`` against the (9, 3C, Cout) permute the kernel took
  before;
* the product as the kernel stages it (each present tap's (zt+2)*C gathered
  rows of a block's 64 columns, the depth padded to 16, bf16 inputs, f32
  sums in the kernel's tap order) against ``gather9_conv_t_plain``;
* the column-gather kernel's walk: every output element of K7 (both row
  orders, every chunk) and K8 is written once, from the table element the
  plain version puts there, for odd M.
"""

import numpy as np
import pytest
import torch

from chip_smoke import second_cfg, second_tiny
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.ops import gather
from toda_tpu_torch.ops._plan import SMEM_LIMIT, row_stride
from toda_tpu_torch.ops.fused_conv import WARPS

torch.set_num_threads(1)


def _stride1_layers(cfg):
    """(C, Cout, nz) of the stride-1 convs of an 8x pillar backbone: the
    first conv (C = 8), stage 1's second, then two per later stage."""
    data = cfg.DATA_CONFIG
    vz = next(p.VOXEL_SIZE for p in data.DATA_PROCESSOR
              if p.NAME == "transform_points_to_voxels")[2]
    rng = data.POINT_CLOUD_RANGE
    nz = int(round((rng[5] - rng[2]) / vz))
    chans = list(cfg.MODEL.BACKBONE_3D.CHANNELS)
    out = [(8, chans[0], nz), (chans[0], chans[0], nz)]
    for ch in chans[1:]:
        nz = -(-nz // 2)
        out += [(ch, ch, nz)] * 2
    return out


def _tiny_second():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    return second_tiny(cfg_from_yaml_file(
        str(root / "tools/cfgs/synthetic_models/second_synthetic.yaml"), EDict()))


PLAN_SHAPES = sorted({(c, cout, nz) for make in (second_cfg, _tiny_second)
                      for c, cout, nz in _stride1_layers(make())}
                     | {(8, 8, 1), (8, 8, 7), (16, 8, 3), (64, 16, 13)})


def test_second_layers_are_the_ones_named():
    assert {(16, 16, 40), (32, 32, 20), (64, 64, 10), (64, 64, 5)} <= set(PLAN_SHAPES)


@pytest.mark.parametrize("esize", (2, 4))
@pytest.mark.parametrize("c,cout,nz", PLAN_SHAPES)
def test_conv_t_plan_fits_and_covers(c, cout, nz, esize):
    """Shared memory within an H100 block's; each output z is summed by
    exactly one block row, whose warps keep at most 20 sum tiles a thread;
    the 16-channel tiles cover Cout and the blocks every column; every staged
    row a product reads lies in the staged tile; the output tile fits where
    the staged tap was."""
    m = 517
    p = gather.conv_t_plan(c, cout, nz, esize, m)
    assert p["smem"] + gather._CONV_T_STATIC <= SMEM_LIMIT
    assert p["coutp"] % 16 == 0 and p["coutp"] >= cout and p["coutp"] - cout < 16
    assert p["kp"] % 16 == 0 and 3 * c <= p["kp"] < 3 * c + 16
    assert 1 <= p["zt"] and p["zt"] * (p["coutp"] // 16) <= gather.CONV_T_ACC
    assert p["rows"] % WARPS == 0
    assert p["grid_x"] * gather.CONV_T_COLS >= m > (p["grid_x"] - 1) * gather.CONV_T_COLS
    assert WARPS * 8 == gather.CONV_T_COLS
    hits = np.zeros(nz, int)
    for y in range(p["grid_y"]):
        z0 = y * p["zt"]
        for zl in range(min(p["zt"], nz - z0)):
            hits[z0 + zl] += 1
            # the deepest staged row the products of this z cell read
            assert zl * c + p["kp"] - 1 < p["rows"]
    assert (hits == 1).all(), hits
    wbytes = p["coutp"] * row_stride(p["kp"] * esize // 16) * 16
    staged = p["rows"] * gather.CONV_T_COLS * esize
    assert p["zt"] * cout * (gather.CONV_T_COLS * esize + 16) <= p["smem"] - 2 * wbytes
    assert staged <= p["smem"] - 2 * wbytes


def test_conv_t_plan_refuses_what_the_kernel_does_not_take():
    for c, cout, nz in ((12, 16, 4), (16, 24, 4), (16, 128, 4), (16, 16, 0)):
        with pytest.raises(ValueError):
            gather.conv_t_plan(c, cout, nz, 2, 100)


@pytest.mark.parametrize("c,cout", ((8, 8), (16, 16), (32, 64), (64, 32)))
def test_packed_weights_equal_the_w9_permute(c, cout):
    rng = np.random.RandomState(c + cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, c, cout)).astype(np.float32))
    p = gather.conv_t_plan(c, cout, 4, 2, 64)
    packed = gather.pack_conv_t_weights(w, p)
    assert packed.shape == (9, p["coutp"], p["kp"]) and packed.dtype == w.dtype
    w9 = w.permute(1, 2, 0, 3, 4).reshape(9, 3 * c, cout)  # [t][dz*C + ci][co]
    assert torch.equal(packed[:, :cout, :3 * c], w9.transpose(1, 2))
    assert not packed[:, cout:].any() and not packed[:, :, 3 * c:].any()


def _staged_product(table, idx, weights, nz, identity):
    """The kernel's product, emulated: per block of 64 columns and z tile,
    the present taps in the kernel's order (the identity tap first), each tap's staged (rows, 64) tile of gathered
    table rows (zero past the table and for missing taps) multiplied by its
    packed (coutp, kp) weights for each output z cell's kp-row window, in
    the table's type with f32 sums; the output rounded once."""
    w, n = table.shape
    m = idx.shape[0]
    c, cout = weights.shape[3:]
    p = gather.conv_t_plan(c, cout, nz, table.element_size(), m)
    packed = gather.pack_conv_t_weights(weights, p).float()
    cols = gather.CONV_T_COLS
    src = idx.long().clone()
    if identity is not None and m == n:
        src[:, identity] = torch.arange(m)
    out = torch.zeros((nz * cout, m))
    for x in range(p["grid_x"]):
        m0 = x * cols
        s = torch.full((cols, 9), -1, dtype=torch.long)
        s[:min(cols, m - m0)] = src[m0:m0 + cols]
        present = [t for t in range(9) if (s[:, t] >= 0).any()]
        if identity in present:  # the kernel takes the identity tap first
            present.remove(identity)
            present.insert(0, identity)
        for y in range(p["grid_y"]):
            z0 = y * p["zt"]
            zt = min(p["zt"], nz - z0)
            acc = torch.zeros((zt, p["coutp"], cols))
            for t in present:
                rows = torch.arange(z0 * c, z0 * c + p["rows"])
                ok = (rows[:, None] < w) & (s[None, :, t] >= 0)
                g = table[rows.clamp(max=w - 1)[:, None], s[None, :, t].clamp(min=0)]
                g = torch.where(ok, g, torch.zeros((), dtype=table.dtype)).float()
                for zl in range(zt):
                    acc[zl] += packed[t] @ g[zl * c:zl * c + p["kp"]]
            ncol = min(cols, m - m0)
            out.view(nz, cout, m)[z0:z0 + zt, :, m0:m0 + ncol] = acc[:, :cout, :ncol]
    return out.to(table.dtype)


@pytest.mark.parametrize("c,cout,nz,m,n,identity,dtype", [
    (8, 8, 3, 133, 133, 4, torch.bfloat16),      # K padded from 24 to 32, Cout padded to 16
    (16, 16, 6, 150, 150, 4, torch.bfloat16),
    (16, 32, 1, 97, 97, None, torch.bfloat16),   # nz 1, no identity tap
    (32, 64, 12, 70, 35, None, torch.bfloat16),  # M = 2N, z cut into 3 tiles
    (16, 8, 4, 129, 129, 4, torch.float32),
])
def test_staged_product_matches_plain(c, cout, nz, m, n, identity, dtype):
    """The emulated kernel against the plain version: 2^-7 relative plus
    2^-12 of the sum of the terms' magnitudes (``chip_smoke.check_k10_call``);
    the block past the first 64 columns has tap 0 absent, so it is skipped."""
    rng = np.random.RandomState(c * cout + nz)
    table = np.zeros(((nz + 2) * c, n), np.float32)
    table[c:-c] = rng.standard_normal((nz * c, n))
    idx = np.sort(rng.randint(0, n, (m, 9)), axis=0)
    idx[rng.rand(m, 9) < 0.4] = -1
    idx[64:128, 0] = -1
    tt = torch.from_numpy(table).to(dtype)
    ti = torch.from_numpy(idx.astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, c, cout)).astype(np.float32)
                         * (2.0 / (27 * c)) ** 0.5).to(dtype)
    got = _staged_product(tt, ti, w, nz, identity).float()
    ref = gather.gather9_conv_t_plain(tt, ti, w, nz, identity).float()
    mag = gather.gather9_conv_t_plain(tt.float().abs(), ti, w.float().abs(), nz,
                                      identity).float()
    assert got.shape == ref.shape == (nz * cout, m)
    err = (got - ref).abs()
    assert (err <= 2.0 ** -7 * ref.abs() + 2.0 ** -12 * mag).all(), err.max()


def _walk_column_gather(table, idx, chunk, identity):
    """The column-gather kernel's walk, emulated: block (x, t, y) takes 256
    columns of tap t and a slice of ``column_gather_rows`` table rows (in
    batches of 16); its
    thread (row vr, vector vc) stores the 16-byte vectors of rows vr, vr +
    VR, ... of the slice, columns vc*V .., to output rows stepped from row
    vr's, not divided; columns past M store nothing. Returns the output and how often
    each element was written."""
    (w, n), (m, ntap) = table.shape, idx.shape
    cols = gather.GATHER_COLS
    slice_rows = gather.column_gather_rows(n, m, ntap, table.element_size())
    v = 16 // table.element_size()
    ch_n = cols // v
    vr_n = 256 // ch_n
    ck = chunk or w
    out = torch.zeros((ntap * w, m), dtype=table.dtype)
    writes = torch.zeros((ntap * w, m), dtype=torch.int32)
    for x in range(-(-m // cols)):
        c0 = x * cols
        for t in range(ntap):
            for y in range(-(-w // slice_rows)):
                r0 = y * slice_rows
                nr = min(slice_rows, w - r0)
                for tid in range(256):
                    vr, vc = divmod(tid, ch_n)
                    if c0 + vc * v >= m:
                        continue
                    c = torch.arange(c0 + vc * v, min(c0 + vc * v + v, m))
                    src = c if t == identity else idx[c, t].long()
                    j, rr = divmod(r0 + vr, ck)
                    for i in range(vr, nr, vr_n):
                        orow = j * ntap * ck + t * ck + rr
                        vals = table[r0 + i, src.clamp(min=0)]
                        out[orow, c] = torch.where(src >= 0, vals,
                                                   torch.zeros((), dtype=table.dtype))
                        writes[orow, c] += 1
                        rr += vr_n
                        while rr >= ck:
                            rr -= ck
                            j += 1
    return out, writes


@pytest.mark.parametrize("w,n,m,chunk,identity,dtype", [
    (48, 37, 37, None, 4, torch.bfloat16),       # odd M, [t][W]
    (64, 37, 37, 16, 4, torch.bfloat16),
    (64, 141, 141, 32, 4, torch.float32),        # a block of 128 f32 columns and a tail
    (128, 70, 70, 64, 4, torch.bfloat16),
    (64, 21, 43, 32, None, torch.bfloat16),      # M = 2N + 1, no identity tap
    (24, 1, 9, 8, None, torch.bfloat16),         # N = 1
    (80, 300, 300, 16, 4, torch.bfloat16),       # two blocks, the second cut by M
    (40, 7, 7, None, None, torch.float32),       # two slices, the second of 8 rows
    (48, 260, 260, 48, 4, torch.float32),        # chunk = W, two f32 blocks
    (136, 12, 30, 8, None, torch.bfloat16),      # five slices, the last of 8 rows
    (16, 5, 5, 1, 4, torch.bfloat16),            # chunk 1: the stepping wraps every row
])
def test_column_gather_walk_writes_each_element_once(w, n, m, chunk, identity, dtype):
    rng = np.random.RandomState(w + m)
    table = torch.from_numpy(rng.standard_normal((w, n)).astype(np.float32)).to(dtype)
    idx = rng.randint(-1, n, (m, 9)).astype(np.int32)
    ti = torch.from_numpy(idx)
    out, writes = _walk_column_gather(table, ti, chunk, identity)
    assert (writes == 1).all(), writes.unique()
    assert torch.equal(out, gather.gather9_stacked_t_plain(table, ti, chunk, identity))


def test_column_gather_walk_k8_taps():
    """K8: T = 3 taps, (T, W, M) rows, no identity."""
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.standard_normal((40, 50)).astype(np.float32))
    ti = torch.from_numpy(rng.randint(-1, 50, (261, 3)).astype(np.int32))
    out, writes = _walk_column_gather(table, ti, None, None)
    assert (writes == 1).all()
    assert torch.equal(out.view(3, 40, 261), gather.gather_rows_taps_t_plain(table, ti))


@pytest.mark.parametrize("n,m,ntap,esize,rows", [
    (262144, 262144, 9, 2, 16), (131072, 131072, 9, 2, 16), (65536, 65536, 9, 2, 32),
    (32768, 32768, 9, 2, 32), (32768, 65536, 9, 2, 32), (65536, 131072, 9, 2, 16),
    (262144, 262144, 3, 2, 16), (262144, 131072, 3, 2, 32), (131072, 65536, 3, 2, 32),
    (32768, 32768, 9, 4, 32), (1, 1, 9, 2, 32)])
def test_column_gather_rows_fit_the_slice(n, m, ntap, esize, rows):
    """SECOND's K7 and K8 tables: 32 table rows a block at most, 16 at
    least, and no more than keep rows x (N + T*M) elements within
    GATHER_SLICE_BYTES where 16 allow."""
    assert gather.column_gather_rows(n, m, ntap, esize) == rows
