"""PV-RCNN's point ops: the PyTorch port against the JAX package.

``toda_tpu_torch.ops.pointnet2_ops`` (the plain versions of the FPS and
ball-query kernels, which the wrappers run on the CPU) against
``toda_tpu.ops.pointnet2_ops`` vmapped over scans, on seeded points in
general position: the indices and counts are equal, the grouped rows equal
to f32 rounding. Cases: invalid points among valid ones, a scan with fewer
valid points than samples (the indices repeat), an invalid query and a
query with no neighbour (its slots hold index 0), radii whose ball holds
fewer and more points than the slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toda_tpu.ops import pointnet2_ops as jops
from toda_tpu_torch.ops import pointnet2_ops as ops

torch.set_num_threads(1)


def scans(seed, b=2, n=300, m=40):
    """b scans of n points in a 20 m box with ~10% invalid, the second
    scan with only 12 valid points; m queries per scan near the points,
    one far from all of them and one invalid."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-10, 10, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    mask[1] = False
    mask[1, rng.choice(n, 12, replace=False)] = True
    q = (xyz[:, rng.choice(n, m, replace=False)] + rng.normal(0, 0.3, (b, m, 3))).astype(
        np.float32)
    q[:, 0] = 100.0  # no neighbour
    qmask = np.ones((b, m), bool)
    qmask[:, 1] = False
    return xyz, mask, q, qmask


@pytest.mark.parametrize("num_samples", [1, 32, 64])
def test_fps_equals_jax(num_samples):
    """The same indices, also where a scan has fewer valid points (12) than
    samples and they repeat."""
    xyz, mask, _, _ = scans(0)
    want = np.asarray(jax.vmap(lambda p, m: jops.farthest_point_sampling(p, m, num_samples))(
        jnp.asarray(xyz), jnp.asarray(mask)))
    got = ops.farthest_point_sampling(torch.from_numpy(xyz), torch.from_numpy(mask), num_samples)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert mask[np.arange(2)[:, None], want].all()
    if num_samples > 12:
        assert len(set(want[1].tolist())) == 12


@pytest.mark.parametrize("radius,nsample", [(0.8, 4), (2.5, 16), (4.0, 8)])
def test_ball_query_equals_jax(radius, nsample):
    """idx and cnt equal; the query with no neighbour and the invalid query
    have count 0 and index 0 in every slot."""
    xyz, mask, q, qmask = scans(1)
    j = jax.vmap(lambda x, xm, nq, qm: jops.ball_query(radius, nsample, x, xm, nq, qm))(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qmask))
    idx, cnt = ops.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(mask),
                              torch.from_numpy(q), torch.from_numpy(qmask), chunk=16)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j[0]))
    assert (cnt[:, :2] == 0).all() and (idx[:, :2] == 0).all()
    assert 0 < cnt[0].float().mean() < nsample


def test_ball_query_bound_is_float32_radius_squared():
    """A point at exactly the radius is out (strict <), and the bound is
    float32(r**2): a point whose f32 d2 equals it is out, one ulp inside
    is in, as in JAX."""
    r = 0.4
    r2 = np.float32(r ** 2)
    inside = np.nextafter(r2, np.float32(0))
    xyz = np.array([[[np.sqrt(np.float64(r2)), 0, 0], [0, np.sqrt(np.float64(inside)), 0],
                     [r, 0, 0]]], np.float32)
    d2 = (xyz.astype(np.float32) ** 2).sum(-1)
    q = np.zeros((1, 1, 3), np.float32)
    ones = np.ones((1, 3), bool)
    j = jops.ball_query(r, 3, jnp.asarray(xyz[0]), jnp.asarray(ones[0]), jnp.asarray(q[0]),
                        jnp.ones(1, bool))
    idx, cnt = ops.ball_query(r, 3, torch.from_numpy(xyz), torch.from_numpy(ones),
                              torch.from_numpy(q), torch.ones((1, 1), dtype=torch.bool))
    np.testing.assert_array_equal(cnt.numpy()[0], np.asarray(j[1]))
    np.testing.assert_array_equal(idx.numpy()[0], np.asarray(j[0]))
    assert int(cnt) == int((d2[0] < r2).sum()) >= 1


def test_query_and_group_equals_jax_chunked():
    """[xyz - query, features] rows and the slot validity against JAX's
    chunked query_and_group (chunk 16 of 40 queries)."""
    xyz, mask, q, qmask = scans(2)
    feats = np.random.RandomState(3).normal(size=xyz.shape[:2] + (5,)).astype(np.float32)
    jg, jv = jax.vmap(lambda x, xm, nq, qm, f: jops.query_and_group_chunked(
        2.5, 16, x, xm, nq, qm, f, chunk=16))(*(jnp.asarray(a) for a in (xyz, mask, q, qmask,
                                                                         feats)))
    g, v = ops.query_and_group(2.5, 16, torch.from_numpy(xyz), torch.from_numpy(mask),
                               torch.from_numpy(q), torch.from_numpy(qmask),
                               torch.from_numpy(feats))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    assert g.shape == (2, 40, 16, 8) and v.any() and not v.all()
