"""The Python side of the port's fused sparse-conv kernels (K1, K2's dx and
dW, K3; ``toda_tpu_torch/ops/fused_conv.py``), on the CPU:

* ``conv_plan`` / ``dw_plan`` for every layer of the flagship
  CenterPoint-Res, the TODA stage-1 model, SECOND on the fused contract and
  the tiny models: each launch fits an H100 block's 232,448 bytes of shared
  memory and its tiles cover every row, z cell and channel;
* the products as the kernels stage them: each present tap's gathered column
  placed in a buffer of the plan's rows (source row r at place*r + 1, zero
  elsewhere), output row i reading the 3*width values from buffer row
  astride*i on, against the plain versions;
* ``tap_lists`` against numpy, and a dW summed pair by pair through those
  lists, split into the kernel's block ranges, against
  ``fused_bnconv9_dw_plain``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import full_cfg, second_cfg, tiny_cfg, toda_cfgs
from toda_tpu_torch.ops import fused_conv as fc
from toda_tpu_torch.ops.fused_conv import SMEM_LIMIT, WARPS, conv_plan, dw_plan, tap_lists

torch.set_num_threads(1)


def _nz(cfg):
    data = cfg.DATA_CONFIG
    vz = next(p.VOXEL_SIZE for p in data.DATA_PROCESSOR
              if p.NAME == "transform_points_to_voxels")[2]
    rng = data.POINT_CLOUD_RANGE
    return int(round((rng[5] - rng[2]) / vz))


def _layers(cfg):
    """(C, Cout, nz_in, z_stride) of the 11 fused convs of an 8x pillar
    backbone: stage 1's two, then a stride-2 down conv and two per stage."""
    chans = list(cfg.MODEL.BACKBONE_3D.CHANNELS)
    nz = _nz(cfg)
    out = [(8, chans[0], nz, 1), (chans[0], chans[0], nz, 1)]
    for prev, ch in zip(chans, chans[1:]):
        out.append((prev, ch, nz, 2))
        nz = fc.out_depth(nz, 2)
        out += [(ch, ch, nz, 1)] * 2
    return out


def _second_fused():
    cfg = second_cfg()
    cfg.MODEL.BACKBONE_3D.FUSED_CONV = True
    return cfg


CONFIGS = {"flagship": (full_cfg, (2,)), "toda_stage1": (lambda: toda_cfgs()[0], (2,)),
           "second_fused": (_second_fused, (2,)), "tiny": (tiny_cfg, (4, 2))}
SHAPES = sorted({(name, e) + layer for name, (make, sizes) in CONFIGS.items()
                 for layer in _layers(make()) for e in sizes})


@pytest.mark.parametrize("name,esize,c,cout,nz,stride", SHAPES)
def test_plans_fit_and_cover(name, esize, c, cout, nz, stride):
    nz_out = fc.out_depth(nz, stride)
    for kind in ("fwd", "dx"):
        p = conv_plan(kind, c, cout, nz, stride, esize, 1000)
        assert p["smem"] <= SMEM_LIMIT, (kind, p)
        assert p["n_out"] == (nz_out if kind == "fwd" else nz) <= 16 * p["mt"]
        assert p["n_blk"] * p["grid_y"] == p["n_total"] == (cout if kind == "fwd" else c)
        assert p["nt"] * 8 == p["n_blk"] and p["nt"] in (1, 2, 4, 8)
        assert p["kpad"] % 16 == 0 and p["kpad"] >= 3 * p["width"]
        # the staged source rows and every row the products read fit the buffer
        assert p["place"] * (p["n_src"] - 1) + 1 < p["buf_rows"]
        assert p["astride"] * (p["n_out"] - 1) + (p["kpad"] - 1) // p["width"] < p["buf_rows"]
        assert p["stages"] in (2, 3, 4)
        assert 1 <= p["grid_x"] * WARPS and p["grid_x"] <= fc.H100_SMS * 2
        assert len(p) == len(fc.PLAN_FIELDS)
    p = dw_plan(c, cout, nz, stride, esize, 1000)
    assert p["smem"] <= SMEM_LIMIT, p
    assert 16 * p["kz"] >= nz_out and p["kpad"] >= 3 * c
    assert p["xrows"] > nz and p["xrows"] > stride * (nz_out - 1) + (p["kpad"] - 1) // c
    assert p["stages"] in (2, 3, 4)
    # the warps of a group tile the whole (3C x Cout) dW of a tap
    assert (p["kpad"] // 16 // p["wm"]) * (cout // 8 // p["wn"]) == p["wpg"]
    assert p["kpad"] // 16 % p["wm"] == 0 and cout // 8 % p["wn"] == 0
    assert p["wpg"] * p["ksplit"] == WARPS and len(p) == len(fc.DW_PLAN_FIELDS)
    assert p["ksplit"] * p["pairs"] == WARPS


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        conv_plan("fwd", 12, 16, 8, 1, 2, 10)  # C not a multiple of 8
    with pytest.raises(ValueError):
        conv_plan("fwd", 16, 16, 50, 1, 2, 10)  # more than 48 z rows
    with pytest.raises(ValueError):
        dw_plan(16, 8, 8, 1, 2, 10)  # Cout not a multiple of 16


def _scene(seed, m_in, m_out, nz, c, cout, stride, density, dtype=torch.float32):
    """Random inputs and a tap table (m_out <= m_in) with about the given
    share of present taps, every column naming an input row at most once
    (as a pillar table does), the centre tap present, some rows with none."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((m_in, nz, c)), dtype=dtype)
    scale = torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32)
    shift = torch.tensor(rng.uniform(-0.5, 0.5, c), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((3, 3, 3, c, cout)) * 0.2, dtype=dtype)
    idx = np.stack([rng.permutation(m_in)[:m_out] for _ in range(9)], 1)
    idx[rng.random((m_out, 9)) > density] = -1
    idx[:, 4] = rng.permutation(m_in)[:m_out]
    idx[rng.random(m_out) < 0.2] = -1  # pillars with no taps
    gy = torch.tensor(rng.standard_normal((m_out, fc.out_depth(nz, stride), cout)), dtype=dtype)
    return x, scale, shift, w, torch.tensor(idx, dtype=torch.int32), gy


def _staged(src, table, bmat, p):
    """sum over present taps of A_t . B_t, A_t read from the gathered source
    column staged as the plan places it (rows place*r + 1 of buf_rows, zero
    elsewhere), output row i < n_out reading the kpad values from buffer
    row astride*i on, the tile's later rows from row 0."""
    m_dst, width, kpad, rows = table.shape[0], p["width"], p["kpad"], p["buf_rows"]
    buf = torch.zeros((src.shape[0] + 1, rows, width))
    buf[:-1, 1 + p["place"] * torch.arange(p["n_src"])] = src.float()
    flat = buf.reshape(buf.shape[0], -1)
    i = torch.arange(16 * p["mt"])[:, None]
    k = torch.arange(kpad)[None, :]
    at = torch.where(i < p["n_out"], p["astride"] * i * width + k, k % width)
    assert int(at.max()) < rows * width
    out = torch.zeros((m_dst, 16 * p["mt"], bmat.shape[-1]))
    for t in range(9):
        j = torch.where(table[:, t] >= 0, table[:, t].long(), src.shape[0])
        out += flat[j][:, at] @ bmat[t]
    return out[:, :p["n_out"]]


@pytest.mark.parametrize("c,cout,nz,stride,act", [
    (8, 16, 8, 1, False), (16, 16, 8, 1, True), (16, 32, 8, 2, True), (16, 16, 5, 2, False),
    (32, 16, 3, 1, True)])
def test_staged_products_equal_the_plain_versions(c, cout, nz, stride, act):
    m_in, m_out = 40, (40 if stride == 1 else 28)
    x, scale, shift, w, idx, gy = _scene(1, m_in, m_out, nz, c, cout, stride, 0.3)
    wf = w.float()
    # K1: B_t[dz*C + c, co] = w[dz, t, c, co], zero past 3C
    p = conv_plan("fwd", c, cout, nz, stride, 4, m_out, act)
    b = torch.zeros((9, p["kpad"], cout))
    b[:, :3 * c] = wf.reshape(3, 9, c, cout).permute(1, 0, 2, 3).reshape(9, 3 * c, cout)
    a = fc._activated(x, scale, shift, act)
    y = _staged(a, idx, b, p)
    ref = fc.fused_bnconv9_plain(x, scale, shift, w, idx, stride, act)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    # dx: the inverse table, B_t[dz'*Cout + co, c] = w[2 - dz', t, c, co]
    inv = torch.full((m_in, 9), -1, dtype=torch.int32)
    for t in range(9):
        keep = idx[:, t] >= 0
        inv[idx[keep, t].long(), t] = torch.nonzero(keep)[:, 0].int()
    p = conv_plan("dx", c, cout, nz, stride, 4, m_in, act)
    b = torch.zeros((9, p["kpad"], c))
    wt = wf.flip(0).reshape(3, 9, c, cout).permute(1, 0, 3, 2).reshape(9, 3 * cout, c)
    b[:, :3 * cout] = wt
    h = _staged(gy, inv, b, p)
    dx, dsc, dsh = fc.fused_bnconv9_bwd_plain(x, scale, shift, w, inv, gy, stride, act)
    if act:
        pre = (x.float() * scale + shift).to(x.dtype).float()
        g = torch.where(pre > 0, h, torch.zeros(()))
        torch.testing.assert_close(g * scale, dx.float(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close((g * x.float()).sum((0, 1)), dsc, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(h, dx.float(), rtol=1e-5, atol=1e-5)


def test_tap_lists_match_numpy():
    _, _, _, _, idx, _ = _scene(2, 70, 64, 4, 8, 16, 1, 0.25)
    idx[:, 7] = -1  # a tap with no rows
    pairs, counts = tap_lists(idx)
    rows, gathered = pairs[..., 0], pairs[..., 1]
    n = idx.numpy()
    assert pairs.shape == (9, 64, 2) and pairs.dtype == torch.int32 and pairs.is_contiguous()
    assert counts.tolist() == (n >= 0).sum(0).tolist()
    for t in range(9):
        k = int(counts[t])
        want = np.nonzero(n[:, t] >= 0)[0]
        assert rows[t, :k].tolist() == want.tolist()  # ascending
        assert gathered[t, :k].tolist() == n[want, t].tolist()
        assert (rows[t, k:] == -1).all() and (gathered[t, k:] == -1).all()  # padding untouched


def _ranges(total, blocks):
    return [(b * total // blocks, (b + 1) * total // blocks) for b in range(blocks)]


@pytest.mark.parametrize("c,cout,nz,stride,act,blocks", [
    (8, 16, 8, 1, False, 7), (16, 32, 8, 2, True, 5), (16, 16, 3, 1, True, 200)])
def test_dw_through_the_lists_equals_the_plain_dw(c, cout, nz, stride, act, blocks):
    """dW summed pair by pair over each tap's list, the concatenated lists cut
    into the kernel's equal block ranges, each tap's segment of a range
    dealt to the groups in turns of ``pairs`` pairs (partials per (block,
    group, tap), added in block and group order), equals the plain dW; every
    pair lands in exactly one group of one block."""
    x, scale, shift, _, idx, gy = _scene(3, 45, 30, nz, c, cout, stride, 0.2)
    idx[:, 2] = -1
    pairs, counts = tap_lists(idx)
    rows, gathered = pairs[..., 0], pairs[..., 1]
    p = dw_plan(c, cout, nz, stride, 4, idx.shape[0], act, sm_count=blocks)
    kz, kpad, ksplit, run = p["kz"], p["kpad"], p["ksplit"], p["pairs"]
    a = fc._activated(x, scale, shift, act)
    xbuf = torch.zeros((x.shape[0], p["xrows"], c))
    xbuf[:, 1:nz + 1] = a
    flat = xbuf.reshape(x.shape[0], -1)
    zo, kk = torch.arange(16 * kz)[None, :], torch.arange(kpad)[:, None]
    at = torch.where(zo < gy.shape[1], stride * zo * c + kk, kk % c)
    assert int(at.max()) < flat.shape[1]
    gbuf = torch.zeros((gy.shape[0], 16 * kz, cout))
    gbuf[:, :gy.shape[1]] = gy.float()
    offs = np.concatenate([[0], np.cumsum(counts.numpy())])
    seen = np.zeros(offs[-1], dtype=int)
    dw = torch.zeros((9, kpad, cout))
    for lo, hi in _ranges(int(offs[-1]), p["blocks"]):
        for t in range(9):
            s_lo, s_hi = max(lo, offs[t]), min(hi, offs[t + 1])
            if s_lo >= s_hi:
                continue
            for grp in range(ksplit):
                part = torch.zeros((kpad, cout))
                for pos in (q for r in range(s_lo + grp * run, s_hi, ksplit * run)
                            for q in range(r, min(r + run, s_hi))):
                    seen[pos] += 1
                    k = pos - offs[t]
                    part += flat[gathered[t, k]][at] @ gbuf[rows[t, k]]
                dw[t] += part
    assert (seen == 1).all()
    got = dw[:, :3 * c].reshape(9, 3, c, cout).permute(1, 0, 2, 3).reshape(3, 3, 3, c, cout)
    ref = fc.fused_bnconv9_dw_plain(x, scale, shift, idx, gy, stride, act)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
