"""The training slice's kernel modules against the JAX package on the same
numpy inputs: the backward of the fused conv (the dx part of K2 with
dscale / dshift, and dW, which is K2's dW part and, with act=False, K3), the
row gather K6 and the dense scatter's VJP. Each port function runs its plain
PyTorch version here (CPU tensors); the CUDA kernels are held to the same
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import dx_tolerance
from test_fused_conv import _down_setup, _no_overflow, _subm_setup
from test_torch_ops import CASES, _conv_case, t, to_port

from toda_tpu.ops import pallas_fused_conv as pfc
from toda_tpu.ops import pallas_gather as pg
from toda_tpu.ops import pillar_sparse as jps
from toda_tpu_torch.ops import fused_conv, gather, pillar_sparse

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def port_grads(x, scale, shift, w, idx, inv, gy, nz, stride, act):
    """(dx, dscale, dshift, dW, h) of the port, in the port's layout, f32;
    h is the cotangent before the relu mask (dx with act=False)."""
    xp = t(to_port(f32(x), nz)).to(torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    dt = xp.dtype
    sc, sh = t(f32(scale)), t(f32(shift))
    gyp = t(to_port(f32(gy), -(-nz // stride))).to(dt)
    dx, dsc, dsh = fused_conv.fused_bnconv9_bwd_dx(xp, sc, sh, t(f32(w)).to(dt), t(inv), gyp,
                                                   stride, act)
    dw = fused_conv.fused_bnconv9_dw(xp, sc, sh, t(idx), gyp, stride, act).to(dt)
    h = fused_conv.fused_bnconv9_bwd_dx(xp, sc, sh, t(f32(w)).to(dt), t(inv), gyp, stride,
                                        False)[0]
    return dx.float().numpy(), dsc.numpy(), dsh.numpy(), dw.float().numpy(), h.float().numpy()


@pytest.mark.parametrize("kind,act", CASES)
def test_backward_plain_matches_jax_grad_f32(kind, act):
    """dx, dscale, dshift and dW of the plain versions vs jax.vjp of
    ``_ref_fwd`` in f32, to 1e-4 of each cotangent's largest value (f32
    sums in another order), for subm (inverse = the mirrored forward table)
    and stride-2 down (inverse from bev_down_tables, nz 5 so the last output
    z reads the halo) layers."""
    k = _conv_case(kind, act, seed=3)
    nz, s = k["nz"], k["stride"]
    nz_out = -(-nz // s)
    gy = np.random.RandomState(4).randn(nz_out * k["w"].shape[-1],
                                        k["idx"].shape[0]).astype(np.float32)
    args = [jnp.asarray(k[n]) for n in ("x", "scale", "shift", "w")]
    _, vjp = jax.vjp(lambda *a: pfc._ref_fwd(*a, jnp.asarray(k["idx"]), nz, s, act), *args)
    jdx, jds, jdb, jdw = vjp(jnp.asarray(gy))
    got = port_grads(*args, k["idx"], k["inv"], gy, nz, s, act)[:4]
    want = (to_port(jdx, nz), jds, jdb, jdw)
    for name, g, w in zip(("dx", "dscale", "dshift", "dW"), got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["subm", "down", "first"])
def test_backward_plain_matches_pallas_kernels_bf16(monkeypatch, kind):
    """The plain backward vs the TPU backward kernels in interpret mode, bf16,
    on the shrunken scenarios of tests/test_fused_conv.py (spans asserted not
    to overflow, so the kernels run, not the fallback): K2 (``_bwd_kernel``)
    for subm and stride-2 down with act, and K3 (``_dw_kernel``, the split
    backward of a raw act=False first layer) for dW. Tolerances as
    test_fused_conv.py: dx 0.1 on valid rows, dscale / dshift atol 2 and
    rtol 0.05 (bf16 sums of ~80k products), dW atol 0.5 and rtol 0.05.
    The TPU kernel forms x*scale + shift in bf16, the port in f32 rounded
    once, so where that pre-activation lies within bf16 rounding of 0
    (|a| <= 2^-7 (|x*scale| + |shift|)) the relu mask may differ: those dx
    elements (asserted to be under 0.5% of the valid ones) are not
    compared, and dscale / dshift get, per channel, the sum of |h*x| / |h|
    over them (h: the cotangent before the mask) on top of atol."""
    monkeypatch.setattr(pfc, "INTERPRET", True)
    rng = np.random.default_rng(5)
    nz = 5
    if kind == "down":
        x, scale, shift, w, idx, inv, mask, om, _ = _down_setup(rng, nz=nz, c=16, cout=32)
        stride, tap, out_mask = 2, None, om
        _no_overflow(idx, x.shape[1], pfc.SPAN_DOWN)
        _no_overflow(inv, idx.shape[0], pfc.SPAN_BWD_DOWN)
    else:
        x, scale, shift, w, idx, inv, mask = _subm_setup(rng, nz=nz, c=16, cout=16)
        stride, tap, out_mask = 1, 4, mask
        _no_overflow(idx, x.shape[1], pfc.SPAN_SUBM)
        _no_overflow(inv, x.shape[1], pfc.SPAN_SUBM)
    act = kind != "first"
    if not act:
        scale, shift = jnp.ones((16,), jnp.bfloat16), jnp.zeros((16,), jnp.bfloat16)
    nz_out = -(-nz // stride)
    gy = jnp.asarray(rng.standard_normal((nz_out * w.shape[-1], idx.shape[0])), jnp.float32)
    gy = (gy * jnp.asarray(out_mask)[None, :]).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: pfc.fused_bnconv9_t(*a, idx, inv, nz, stride, tap, act,
                                                    split_bwd=not act),
                     x, scale, shift, w)
    jdx, jds, jdb, jdw = vjp(gy)
    dx, dsc, dsh, dw, h = port_grads(x, scale, shift, w, np.asarray(idx), np.asarray(inv),
                                     gy, nz, stride, act)
    xs = to_port(f32(x), nz) * f32(scale)
    near = np.abs(xs + f32(shift)) <= 2.0 ** -7 * (np.abs(xs) + np.abs(f32(shift)))
    rows = np.broadcast_to(np.asarray(mask)[:, None, None], near.shape)
    keep = rows & ~(near & act)
    assert (rows & ~keep).sum() <= 5e-3 * rows.sum()
    np.testing.assert_allclose(dx[keep], to_port(f32(jdx), nz)[keep], rtol=0.1, atol=0.1,
                               err_msg="dx")
    if act:
        flips = rows & ~keep
        hx = np.abs(h * to_port(f32(x), nz)) * flips
        for name, g, want, extra in (("dscale", dsc, jds, hx.sum((0, 1))),
                                     ("dshift", dsh, jdb, (np.abs(h) * flips).sum((0, 1)))):
            err = np.abs(g - f32(want))
            assert (err <= 2.0 + extra + 0.05 * np.abs(f32(want))).all(), (name, err, extra)
    np.testing.assert_allclose(dw, f32(jdw), rtol=0.05, atol=0.5, err_msg="dW")


@pytest.mark.parametrize("kind,act", CASES)
def test_chip_dx_check_fails_planted_faults(kind, act):
    """``chip_smoke.dx_tolerance``, the card's check of the dx kernel against
    its plain version, on bf16 gradient-sized cotangents (|gy| ~ 1e-3): the
    plain dx with its products summed in another order passes; a dropped
    centre tap, a mirrored inverse table, dz taps swapped, a lost relu mask,
    a missing scale, a 2% scale error and an all-zero dx fail."""
    k = _conv_case(kind, act, seed=8)
    x = t(to_port(k["x"], k["nz"])).to(torch.bfloat16)
    sc, sh, s = t(k["scale"]), t(k["shift"]), k["stride"]
    w, invf = t(k["w"]).to(torch.bfloat16), t(k["inv"])
    rng = np.random.RandomState(9)
    gy = t(1e-3 * rng.randn(k["idx"].shape[0], -(-k["nz"] // s), w.shape[-1]).astype(
        np.float32)).to(torch.bfloat16)

    def dx(w=w, invf=invf, act=act):
        return fused_conv.fused_bnconv9_bwd_plain(x, sc, sh, w.contiguous(), invf.contiguous(),
                                                  gy.contiguous(), s, act)[0].float()

    ref = dx()
    tol = dx_tolerance(x, sc, w, invf, gy, s, act, ref)
    perm = torch.as_tensor(rng.permutation(w.shape[-1]))
    reordered = fused_conv.fused_bnconv9_bwd_plain(x, sc, sh, w[..., perm].contiguous(), invf,
                                                   gy[..., perm].contiguous(), s, act)[0]
    assert ((reordered.float() - ref).abs() <= tol).all()
    dropped = invf.clone()
    dropped[:, 4] = -1
    faults = {"dropped tap": dx(invf=dropped), "mirrored table": dx(invf=invf.flip(1)),
              "dz swapped": dx(w=w.flip(0)), "zero": torch.zeros_like(ref),
              "scale 1.02": ref * 1.02}
    if act:
        faults["no relu mask"] = dx(act=False) * sc
        faults["no scale"] = ref / sc
    for name, v in faults.items():
        assert ((v - ref).abs() > tol).any(), name


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_rows_matches_pallas_interpret(monkeypatch, dtype):
    """K6 plain vs ``gather_rows``'s TPU kernel in interpret mode: exact.
    The indices are sorted with -1 holes, as the dense scatter's keys are,
    and the prologue is asserted not to overflow (the kernel runs)."""
    rng = np.random.RandomState(6)
    n, m, w = 1024, 512, 128
    idx = np.sort(rng.randint(0, n, m)).astype(np.int32)
    idx[rng.rand(m) < 0.2] = -1
    table = jnp.asarray(rng.randn(n, w).astype(np.float32)).astype(dtype)
    lo, li, overflow = pg._gather_prologue(jnp.asarray(idx), n)
    assert not bool(overflow)
    monkeypatch.setattr(pg, "INTERPRET", True)
    ref = f32(pg._pallas_gather(table, lo, li, m))
    pt = t(f32(table)).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = gather.gather_rows(pt, t(idx))
    assert got.dtype == pt.dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(ref, f32(pg.gather_rows(table, jnp.asarray(idx))))


def test_pillars_to_dense_vjp_matches_jax():
    """The dense scatter's backward (K6 through the autograd Function) equals
    JAX's VJP of ``pillars_to_dense_batched``, bf16 features."""
    rng = np.random.RandomState(7)
    bt, p, nz, c, bev = 2, 64, 3, 4, (12, 10)
    keys = np.stack([np.sort(rng.choice(120, 50, replace=False)) for _ in range(bt)])
    coords = np.full((bt, p, 2), -1, np.int32)
    coords[:, :50, 0], coords[:, :50, 1] = keys // 10, keys % 10
    mask = coords[..., 0] >= 0
    feats = jnp.asarray(rng.randn(bt, p, nz, c).astype(np.float32)).astype(jnp.bfloat16)
    gbar = jnp.asarray(rng.randn(bt, *bev, nz, c).astype(np.float32)).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda f: jps.pillars_to_dense_batched(f, jnp.asarray(coords),
                                                            jnp.asarray(mask), bev), feats)
    (want,) = vjp(gbar)
    ft = t(f32(feats)).bfloat16().requires_grad_()
    dense = pillar_sparse.pillars_to_dense_batched(ft, t(coords), t(mask), bev)
    assert dense.dtype == torch.bfloat16
    dense.backward(t(f32(gbar)).bfloat16())
    np.testing.assert_array_equal(ft.grad.float().numpy(), f32(want))
