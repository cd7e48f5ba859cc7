"""PV-RCNN's point ops: the PyTorch port against the JAX package.

``toda_tpu_torch.ops.pointnet2_ops`` (the plain versions of the FPS and
ball-query kernels, which the wrappers run on the CPU) against
``toda_tpu.ops.pointnet2_ops`` vmapped over scans, on seeded points in
general position: the indices and counts are equal, the grouped rows equal
to f32 rounding. Cases: invalid points among valid ones, a scan with fewer
valid points than samples (the indices repeat), an invalid query and a
query with no neighbour (its slots hold index 0), radii whose ball holds
fewer and more points than the slots. The card's ball query bins the
candidates into a grid first; its binning's plain version
(``ball_query_grid``, the same f32 operations in PyTorch) runs here: on
clouds with invalid points, negative coordinates, points on cell
boundaries, queries outside the cloud and voxel-centre lattices whose
spacing divides the radius, every in-ball point lies in one of its
query's ranges, and the nsample smallest in-ball indices among the ranges
are the plain version's answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toda_tpu.ops import pointnet2_ops as jops
from toda_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
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


def beats(d, i, bd, bi):
    """The plain FPS's argmax order: a larger distance, or an equal one at a
    lower index."""
    return d > bd or (d == bd and i < bi)


KEY_VALUES = {
    "ties": [0.0, 1.0, 2.5, 1e9],
    "zero": [0.0, float(np.nextafter(np.float32(0), np.float32(1))), 1e-30],
    "big": [1e9, float(np.nextafter(np.float32(1e9), np.float32(0))),
            float(np.nextafter(np.float32(1e9), np.float32(2e9)))],
    "negative": [-1e9, float(np.nextafter(np.float32(-1e9), np.float32(0))), -1.0,
                 float("-inf"), 0.0],
    "neighbours": [float(v) for v in np.nextafter(np.float32(3.7), np.float32([0, 3.7, 9]))],
}


@pytest.mark.parametrize("values", sorted(KEY_VALUES))
def test_fps_key_order_equals_beats(values):
    """FPS's packed key (distance bits, then the inverted index) orders every
    pair of (distance, index) as ``beats`` does: over ties, 0, 1e9, -1e9,
    -inf and neighbouring floats, at indices 0, 1, 7 and 2**18 - 1."""
    pairs = [(np.float32(d), i) for d in KEY_VALUES[values] for i in (0, 1, 7, 2 ** 18 - 1)]
    d = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    i = torch.tensor([p[1] for p in pairs])
    key = ops.fps_key(d, i).tolist()
    for a, (da, ia) in enumerate(pairs):
        assert int(ops.fps_key_index(torch.tensor(key[a]))) == ia
        for b, (db, ib) in enumerate(pairs):
            assert (key[a] > key[b]) == beats(da, ia, db, ib), (pairs[a], pairs[b])


def face_cloud(seed, b=3, n=480, group=12):
    """Groups of ``group`` points with points on their boxes' faces and
    corners and duplicates: per group a random box, its two corners, points
    with one coordinate on a face, exact duplicates; ~10% invalid, the last
    scan all invalid. Samples: random, on the faces, inside a box and the
    points themselves."""
    rng = np.random.RandomState(seed)
    g = n // group
    lo = rng.uniform(-10, 10, (b, g, 1, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 3, (b, g, 1, 3)).astype(np.float32)
    p = (lo + rng.uniform(0, 1, (b, g, group, 3)) * (hi - lo)).astype(np.float32)
    p[:, :, 0], p[:, :, 1] = lo[:, :, 0], hi[:, :, 0]
    axis = rng.randint(0, 3, (b, g))
    for k in (2, 3):
        face = np.where(rng.uniform(size=(b, g, 1)) < 0.5, lo[:, :, 0], hi[:, :, 0])
        np.put_along_axis(p[:, :, k], axis[..., None], np.take_along_axis(
            face, axis[..., None], -1), -1)
    p[:, :, 4] = p[:, :, 5]
    mask = rng.uniform(size=(b, g, group)) > 0.1
    mask[-1] = False
    s = np.concatenate([rng.uniform(-12, 14, (b, 64, 3)), p.reshape(b, -1, 3)[:, :64],
                        lo[:, :16, 0] + 0.5 * (hi[:, :16, 0] - lo[:, :16, 0])], 1)
    s[:, 64:96, 0] = lo[:, :32, 0, 0]
    return p, mask, s.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_fps_lower_bound_never_exceeds_members(seed):
    """fps_lower_bound of each group's box (over its valid points) to every
    sample is at most the f32 sq_dist from the sample to every valid member,
    with points on the boxes' faces and corners and duplicates; an
    all-invalid group's bound is +inf (its box is empty)."""
    p, mask, s = (torch.from_numpy(a) for a in face_cloud(seed))
    lo, hi = ops.fps_boxes(p, mask)
    lb = ops.fps_lower_bound(lo[:, None], hi[:, None], s[:, :, None])  # (B, S, G)
    d = ops.sq_dist(p[:, None], s[:, :, None, None])  # (B, S, G, group)
    member = mask[:, None].expand_as(d)
    assert (lb[..., None].expand_as(d)[member] <= d[member]).all()
    assert torch.isinf(lb[-1]).all() and (lb[-1] > 0).all()
    assert (lb[:-1] == 0).any() and (lb[:-1] > 0).any()
    touch = lb[..., None].expand_as(d)[member] == d[member]
    assert touch.any()  # samples on a member: the bound is tight there


def bucket_cases():
    rng = np.random.RandomState(8)
    base = rng.uniform(-5, 5, (2, 40, 3)).astype(np.float32)
    dup = base[:, rng.randint(0, 40, 600)]
    dmask = np.ones((2, 600), bool)
    dmask[1, ::3] = False
    few = rng.uniform(-10, 10, (2, 300, 3)).astype(np.float32)
    fmask = np.zeros((2, 300), bool)
    fmask[0, rng.choice(300, 10, replace=False)] = True
    fmask[1, 100:] = True
    return {"duplicates": (dup, dmask, 64, 12), "fewer_valid": (few, fmask, 48, 4)}


@pytest.mark.parametrize("case", ["duplicates", "fewer_valid"])
def test_fps_buckets_equal_jax(case):
    """The bucketed plain FPS (the kernel's pruning: boxes of consecutive
    sorted points, skipped where the bound proves no distance changes)
    gives JAX's indices: on 40 distinct positions repeated 600 times (ties
    between duplicates far apart in index), and with fewer valid points
    than samples (10 of 300: the indices repeat); it prunes some work."""
    xyz, mask, ns, group = bucket_cases()[case]
    want = np.asarray(jax.vmap(lambda p, m: jops.farthest_point_sampling(p, m, ns))(
        jnp.asarray(xyz), jnp.asarray(mask)))
    got, share = ops.farthest_point_sampling_buckets(torch.from_numpy(xyz),
                                                     torch.from_numpy(mask), ns, group)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < share < 1


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


def check_grid(radius, nsample, xyz, mask, q, qmask):
    """ball_query_grid's ranges against brute force, query by query: they
    are disjoint, hold only valid candidates of the query's own scan and
    every in-ball point; the nsample smallest in-ball indices among them
    (the grid kernel's merge) and the count equal ball_query_plain's."""
    b, n, _ = xyz.shape
    t = [torch.from_numpy(a) for a in (xyz, mask, q, qmask)]
    order, ranges = ops.ball_query_grid(radius, t[0], t[1], t[2])
    assert order.shape == (b * n,) and ranges.shape == q.shape[:2] + (9, 2)
    assert ranges.dtype == torch.int32
    order, ranges = order.numpy(), ranges.numpy()
    idx, cnt = (a.numpy() for a in ops.ball_query_plain(radius, nsample, *t))
    inball = (ops.sq_dist(t[2][:, :, None], t[0][:, None]) < ops.radius_sq(radius)).numpy() \
        & mask[:, None] & qmask[..., None]
    for i in range(b):
        for j in range(q.shape[1]):
            got = np.concatenate([order[s:e] for s, e in ranges[i, j]])
            assert len(np.unique(got)) == len(got)
            assert (got // n == i).all() and mask.reshape(-1)[got].all()
            want = np.flatnonzero(inball[i, j])
            assert np.isin(want, got % n).all(), (i, j, np.setdiff1d(want, got % n))
            hits = np.sort((got % n)[inball[i, j, got % n]])[:nsample] if qmask[i, j] else []
            assert cnt[i, j] == len(hits)
            np.testing.assert_array_equal(idx[i, j, :len(hits)], hits)
    return inball.sum()


def boundary_cloud(seed, radius, b=3, n=301, m=48):
    """b scans of n points (N not a multiple of 32) in [-6, 4)^3, ~10%
    invalid, the third scan all invalid; a point at the grid's corner
    (-6, -6, -6), a quarter of the points on cell boundaries of
    ball_query_grid's grid (corner + k * side and the f32 values next to
    them); queries on boundaries, near points, one just outside the
    corner (within radius of it), one far outside, one invalid."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-6, 4, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    mask[2] = False
    corner = np.float32(-6)
    xyz[0, 0], mask[0, 0] = corner, True
    side = np.float32(radius * (1 + ops.BQ_CELL_MARGIN))
    on = corner + rng.randint(0, int(10 / side), (b, n // 4, 3)).astype(np.float32) * side
    on = np.nextafter(on, on + rng.choice([-1, 0, 1], on.shape).astype(np.float32))
    xyz[:, 1:n // 4 + 1] = np.maximum(on, corner)
    q = (xyz[:, rng.choice(n, m, replace=False)]
         + rng.choice([0, 1], (b, m, 1)) * rng.normal(0, radius, (b, m, 3))).astype(np.float32)
    q[:, :8] = xyz[:, 1:9] + np.float32(radius) * np.eye(3, dtype=np.float32)[
        rng.randint(0, 3, 8)]
    q[:, 8] = corner - np.float32(0.9 * radius)
    q[:, 9] = 40.0
    qmask = np.ones((b, m), bool)
    qmask[:, 10] = False
    return xyz, mask, q, qmask


@pytest.mark.parametrize("seed,radius,nsample", [(4, 0.4, 16), (5, 0.8, 8), (6, 1.5, 64)])
def test_ball_query_grid_covers_the_ball(seed, radius, nsample):
    """Coverage and the merge on boundary_cloud; balls holding more points
    than slots and fewer."""
    xyz, mask, q, qmask = boundary_cloud(seed, radius)
    assert check_grid(radius, nsample, xyz, mask, q, qmask) > 0


def lattice(seed, b=2, pillars=100):
    """x_conv4-like sources: the voxel centres of ``pillars`` pillars of a
    12 x 12 block at stride 8 of Waymo's 0.1 m grid (a 0.8 m lattice) and
    5 z-sites each, as ``_voxel_source_points`` computes them; ~10% of the
    pillars invalid, the second scan all invalid. Queries: lattice sites,
    lattice sites moved by 2.4 m along x (exactly 3 steps), random points
    in the block, one invalid."""
    rng = np.random.RandomState(seed)
    cells = np.stack([rng.permutation(144)[:pillars] for _ in range(b)])
    coords = torch.from_numpy(np.stack([cells // 12 + 40, cells % 12 + 50], -1))
    pmask = rng.uniform(size=(b, pillars)) > 0.1
    pmask[1] = False
    ms = {"features": torch.zeros((b, pillars, 5, 1)), "coords": coords,
          "mask": torch.from_numpy(pmask), "stride": 8}
    xyz, _, mask = vsa._voxel_source_points(ms, (0.1, 0.1, 0.15), (-75.2, -75.2, -2.0), 40)
    xyz, mask = xyz.numpy(), mask.numpy()
    m = 40
    pick = rng.choice(xyz.shape[1], m, replace=False)
    q = xyz[:, pick].copy()
    q[:, 10:20, 0] += np.float32(2.4)
    q[:, 20:30] += rng.uniform(-1.2, 1.2, (b, 10, 3)).astype(np.float32)
    qmask = np.ones((b, m), bool)
    qmask[:, 0] = False
    return xyz, mask, q, qmask


@pytest.mark.parametrize("radius,nsample", [(2.4, 16), (4.8, 32)])
def test_ball_query_lattice_equals_jax(radius, nsample):
    """On the 0.8 m lattice the radii are exact multiples of the spacing:
    idx and cnt equal JAX's, with the strict < and float32(r**2) deciding
    the points at the radius; the grid covers every ball there and its
    merge gives the same answer."""
    xyz, mask, q, qmask = lattice(7)
    j = jax.vmap(lambda x, xm, nq, qm: jops.ball_query(radius, nsample, x, xm, nq, qm))(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qmask))
    idx, cnt = ops.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(mask),
                              torch.from_numpy(q), torch.from_numpy(qmask))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j[0]))
    assert (cnt[1] == 0).all() and (idx[1] == 0).all() and (cnt[0, 1:] > 0).all()
    assert check_grid(radius, nsample, xyz, mask, q, qmask) > 0


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
