"""The TODA slice's kernel backwards and K10: the PyTorch port against the JAX
package on the same numpy inputs, on the CPU.

The pseudo-label perturbation differentiates the detector's loss with
respect to the raw points: K4's VJP (a K6 gather of the cotangent), K5's VJP
(the VJP of its plain version), the voxelizer as a whole, and the raw first
conv's dx with act=False (JAX's split backward), each against ``jax.vjp``
or JAX's kernel in interpret mode. K10 (``gather9_conv_t``, the fused
column gather + stride-1 conv) against JAX's Pallas kernel in interpret mode
and its XLA fallback. Each port function runs its plain version here (CPU
tensors); ``chip_smoke.py`` holds the CUDA kernels to the same plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_fused_conv import _no_overflow, _subm_setup
from test_torch_ops import VOX, _scan, _sorted_idx_with_tails, t, to_port
from test_torch_second_ops import _tables

from toda_tpu.ops import pallas_fused_conv as pfc
from toda_tpu.ops import pallas_gather as pg
from toda_tpu.ops import pillar_sparse as jps
from toda_tpu_torch.ops import fused_conv, gather, pillar_sparse

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_scatter_rows_add_vjp_equals_jax():
    """K4's backward, a K6 gather of the (n, W) f32 cotangent by the same
    idx (zero rows where -1), equals ``jax.vjp`` of JAX's scatter_rows_add
    exactly, for f32 and bf16 rows (the gradient comes back in the rows'
    type), and JAX's own gather of the same cotangent."""
    rng = np.random.RandomState(4)
    idx = _sorted_idx_with_tails(rng, 2, 300, 1024, 700)
    g = rng.randn(idx.size, 5).astype(np.float32)
    gbar = rng.randn(600, 5).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        gj = jnp.asarray(g, jdt)
        _, vjp = jax.vjp(lambda a: pg.scatter_rows_add(a, jnp.asarray(idx), 600,
                                                       out_dtype=jnp.float32), gj)
        (want,) = vjp(jnp.asarray(gbar))
        gp = t(f32(gj)).to(tdt).requires_grad_()
        out = gather.scatter_rows_add(gp, t(idx), 600)
        out.backward(t(gbar))
        assert gp.grad.dtype == tdt
        np.testing.assert_array_equal(gp.grad.float().numpy(), f32(want))
    np.testing.assert_array_equal(
        gather.gather_rows(t(gbar), t(idx)).numpy(),
        np.asarray(pg.gather_rows(jnp.asarray(gbar), jnp.asarray(idx))))


def test_unpack_pillars_vjp_equals_jax():
    """K5's backward against ``jax.vjp`` of ``unpack_pillars_t`` (whose VJP
    is its reference's) from the same bf16 output cotangent: the feature
    sums get cotangent / max(round(count), 1), the count column nothing; to
    1e-6 relative (one f32 division each). The packed (hi, lo) layout of
    the JAX input is converted as in ``test_torch_ops``."""
    rng = np.random.RandomState(5)
    bt, p, nz, c, cpad = 2, 256, 8, 4, 8
    ncell = bt * p * nz
    sums = np.zeros((ncell, c + 1), np.float32)
    sums[:, c] = rng.randint(0, 5, ncell)
    sums[:, :c] = rng.randn(ncell, c).astype(np.float32) * 3 * sums[:, c:]
    raw = np.zeros((bt, p * nz // 8, 128), np.float32)
    cells = sums.reshape(bt, p * nz // 8, 8, c + 1)
    for g in range(8):
        for k in range(c + 1):
            raw[:, :, g * 16 + 2 * k] = cells[:, :, g, k]
    gy = jnp.asarray(rng.randn(nz * cpad, bt * p), jnp.bfloat16)
    _, vjp = jax.vjp(lambda o: pg.unpack_pillars_t(o, nz, c, cpad, p), jnp.asarray(raw))
    (graw,) = vjp(gy)
    want = np.asarray(graw).reshape(bt, p * nz // 8, 8, 16)[..., 0:2 * (c + 1):2]
    want = want.reshape(ncell, c + 1)
    sp = t(sums).requires_grad_()
    out = gather.unpack_pillars(sp, c, cpad, torch.bfloat16)
    out.backward(t(to_port(f32(gy), nz)).reshape(ncell, cpad).bfloat16())
    np.testing.assert_allclose(sp.grad.numpy(), want, rtol=1e-6, atol=0)
    assert not sp.grad[:, c].any()


def test_voxelizer_points_gradient_equals_jax():
    """The gradient of a fixed linear function of the voxelizer's mean
    features with respect to the points (all four columns) equals
    ``jax.grad`` through JAX's voxelizer to 1e-6 of its largest value:
    each point in a kept cell gets the cell's cotangent over its count;
    points in cells past MAX_PILLARS, outside the grid or masked get 0."""
    max_pillars = 256
    pts, mask = _scan(np.random.RandomState(6))
    v = VOX
    cot = np.random.RandomState(7).randn(2, max_pillars, v["nz"], 4).astype(np.float32)

    def jloss(p_):
        out = jps.voxelize_pillars_batched(p_, jnp.asarray(mask), v["voxel_size"],
                                           v["pc_range"], v["grid_size"], max_pillars, v["nz"])
        return (out["pillar_features"] * cot).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))
    pp = t(pts).requires_grad_()
    got = pillar_sparse.voxelize_pillars_batched(pp, t(mask), v["voxel_size"], v["pc_range"],
                                                 v["grid_size"], max_pillars, v["nz"])
    x = got["x"].reshape(2, max_pillars, v["nz"], 8)
    (x[..., :4] * t(cot)).sum().backward()
    assert np.abs(want).max() > 0 and (want == 0).any()
    np.testing.assert_allclose(pp.grad.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_first_conv_dx_equals_jax_split_backward_interpret(monkeypatch):
    """The raw first conv's input gradient: the port's dx with act=False
    (8 input channels, the voxelizer's padded width, as the backbones'
    first conv) against JAX's split backward (``_split_vjp_bwd``: its dx
    kernel ``_call_bwd`` with want_dw=False) in interpret mode, bf16, on the
    valid rows, to 2^-7 relative plus 2^-12 of the sum of the terms'
    magnitudes (f32 sums in another order, rounded to bf16), the
    tolerance ``chip_smoke.dx_tolerance`` applies on the card. The spans
    are asserted not to overflow, so the kernel runs, not its fallback."""
    from chip_smoke import dx_tolerance

    monkeypatch.setattr(pfc, "INTERPRET", True)
    rng = np.random.default_rng(8)
    nz, c, cout = 5, 8, 16
    x, _, _, w, idx, inv, mask = _subm_setup(rng, nz=nz, c=c, cout=cout)
    _no_overflow(idx, x.shape[1], pfc.SPAN_SUBM)
    _no_overflow(inv, x.shape[1], pfc.SPAN_SUBM)
    one, zero = jnp.ones((c,), jnp.bfloat16), jnp.zeros((c,), jnp.bfloat16)
    gy = jnp.asarray(rng.standard_normal((nz * cout, idx.shape[0])), jnp.float32)
    gy = (gy * jnp.asarray(mask)[None, :]).astype(jnp.bfloat16)
    assert pfc.fused_ok(x.shape, x.dtype, c, cout, idx.shape[0], nz, 1)
    _, vjp = jax.vjp(lambda x_: pfc.fused_bnconv9_t(x_, one, zero, w, idx, inv, nz, 1, 4,
                                                    False, split_bwd=True), x)
    (jdx,) = vjp(gy)
    xp = t(to_port(f32(x), nz)).bfloat16()
    wp, invp = t(f32(w)).bfloat16(), t(np.asarray(inv))
    gyp = t(to_port(f32(gy), nz)).bfloat16()
    sc, sh = torch.ones(c), torch.zeros(c)
    dx, dsc, dsh = fused_conv.fused_bnconv9_bwd_dx(xp, sc, sh, wp, invp, gyp, 1, False)
    assert not dsc.any() and not dsh.any()
    tol = dx_tolerance(xp, sc, wp, invp, gyp, 1, False, dx).numpy()
    rows = np.asarray(mask)
    err = np.abs(dx.float().numpy() - to_port(f32(jdx), nz))[rows]
    assert np.abs(f32(jdx)).max() > 0
    assert (err <= tol[rows]).all(), err.max()


def _k10_case(rng, nz=3, c=8, cout=16, n=512):
    """A zero-haloed (W = (nz+2)*C, N) table, the K7 scenario's monotone
    (N, 9) taps with the identity tap on each column itself, and weights."""
    table, idx = _tables(rng, w=nz * c, n=n, m=n)
    table = np.pad(table, ((c, c), (0, 0)))
    idx[:, 4] = np.arange(n)
    w = (rng.standard_normal((3, 3, 3, c, cout)) * 0.3).astype(np.float32)
    return table, idx, w


def test_k10_plain_equals_jax_interpret_kernel(monkeypatch):
    """K10's plain version against JAX's ``_gather9_conv_kernel`` in
    interpret mode, bf16 (the kernel's type on the TPU), identity tap 4:
    both sum the same bf16 products in f32 and round once, so they agree
    to one bf16 ulp (2^-7 relative) plus 2^-16 of the sum of the terms'
    magnitudes (the f32 sums' order)."""
    nz, c, cout = 3, 8, 16
    table, idx, w = _k10_case(np.random.RandomState(9), nz, c, cout)
    tj, ij = jnp.asarray(table, jnp.bfloat16), jnp.asarray(idx)
    wj = jnp.asarray(w, jnp.bfloat16)
    tp, wp = t(f32(tj)).bfloat16(), t(f32(wj)).bfloat16()
    got = gather.gather9_conv_t(tp, t(idx), wp, nz, identity_tap=4)
    assert got.shape == (nz * cout, idx.shape[0]) and got.dtype == torch.bfloat16
    mag = gather.gather9_conv_t_plain(tp.float().abs(), t(idx), wp.float().abs(), nz, 4).numpy()
    monkeypatch.setattr(pg, "INTERPRET", True)
    meta, li4, overflow = pg._stacked_prologue(ij, table.shape[1], pg.SPAN_T)
    assert not bool(overflow)
    w9 = wj.transpose(1, 2, 0, 3, 4).reshape(9, 3 * c, cout)
    want = f32(pg._pallas_gather9_conv(tj, meta, li4, w9, idx.shape[0], pg.SPAN_T, nz, c,
                                       cout, 4))
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 2.0 ** -16 * mag).all(), err.max()


def test_k10_plain_equals_jax_fallback_f32():
    """K10's plain version against ``gather9_conv_t``'s XLA fallback (nine
    gathers, a convolution each) in f32, identity tap off (the fallback
    gathers every tap), to 1e-5 of the output's largest magnitude; and with
    the identity tap, against the fallback on a table whose identity column
    is the column's own index (copying and gathering agree there)."""
    nz, c, cout = 4, 16, 8
    table, idx, w = _k10_case(np.random.RandomState(10), nz, c, cout)
    want = f32(pg.gather9_conv_t(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), nz))
    for tap in (None, 4):
        got = gather.gather9_conv_t(t(table), t(idx), t(w), nz, identity_tap=tap).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
