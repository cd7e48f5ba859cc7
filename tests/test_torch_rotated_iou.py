"""Rotated IoU of boxes that abut: the port's repair (F11) beside the JAX
package, and the zero-size box, which neither package handles and every
caller masks (pinned, not repaired).

Two boxes whose edges lie on one line and run opposite ways touch along it
and overlap by 0. JAX's edge clipping keeps the first box's piece of the
shared line without the matching piece of the second's, so it gives them an
overlap (0.5 m^2 and an IoU of 0.0370 for the boxes below); the port gives
0. Elsewhere the two agree: identical boxes, boxes sharing an edge on the
same side, boxes 1 cm apart in overlap.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toda_tpu.ops import rotated_iou as jiou
from toda_tpu_torch.ops import nms, rotated_iou

torch.set_num_threads(1)

FUNCS = ("boxes_overlap_bev", "boxes_iou_bev", "boxes_iou3d")


def both(a, b):
    """{name: (JAX's value, the port's)} of each function on boxes a, b."""
    a, b = np.array([a], np.float32), np.array([b], np.float32)
    return {f: (float(np.asarray(getattr(jiou, f)(jnp.asarray(a), jnp.asarray(b)))[0, 0]),
                float(getattr(rotated_iou, f)(torch.from_numpy(a), torch.from_numpy(b))[0, 0]))
            for f in FUNCS}


def rotated_pair(heading, gap):
    """A 4 x 2 box at the origin and a 2 x 1 box past its front edge (in
    the box frame: 3 - gap ahead, 0.3 to the side), both at ``heading``."""
    c, s = math.cos(heading), math.sin(heading)
    x, y = 3.0 - gap, 0.3
    return [0, 0, 0, 4, 2, 1, heading], [x * c - y * s, x * s + y * c, 0, 2, 1, 1, heading]


def test_abutting_boxes_overlap_zero_repair():
    """The 6 x 2 and 2 x 1 boxes touch along x = 0: JAX gives an overlap of
    0.5 and a BEV and 3D IoU of 0.0370, the port 0."""
    got = both([-3, 0, 0, 6, 2, 1, 0], [1, 0.5, 0, 2, 1, 1, 0])
    np.testing.assert_allclose([got[f][0] for f in FUNCS], [0.5, 0.037037, 0.037037], rtol=1e-4)
    assert [got[f][1] for f in FUNCS] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("case", ["y_axis", "rotated"])
def test_unequal_abutting_boxes_overlap_zero_repair(case):
    """Boxes of unequal size abutting along y, and rotated by 0.5 rad along
    the first box's front edge: JAX overlaps them, the port does not."""
    a, b = ([0, 0, 0, 4, 2, 1, 0], [0.5, 1.5, 0, 1, 1, 1, 0]) if case == "y_axis" \
        else rotated_pair(0.5, 0.0)
    got = both(a, b)
    assert got["boxes_overlap_bev"][0] > 0.1 and got["boxes_iou_bev"][0] > 0.01
    assert [got[f][1] for f in FUNCS] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("a,b,want", [
    ([0, 0, 0, 4, 2, 1, 0], [0, 0, 0, 4, 2, 1, 0], 8.0),
    ([0, 0, 0, 4, 2, 1, 0], [1, 0, 0, 2, 2, 1, 0], 4.0),  # three edges shared, same side
    (*rotated_pair(0.5, 0.01), 0.01),  # 1 cm of overlap along the rotated front edge
    ([0, 0, 0, 4, 2, 1, 0.3], [1, 0.5, 0, 3, 2, 1, -0.2], None),
])
def test_overlapping_boxes_equal_jax(a, b, want):
    """Where the boxes overlap, the port equals JAX to 1e-5 of the area."""
    got = both(a, b)
    for f in FUNCS:
        np.testing.assert_allclose(got[f][1], got[f][0], rtol=1e-5, atol=1e-6, err_msg=f)
    if want is not None:
        np.testing.assert_allclose(got["boxes_overlap_bev"][1], want, rtol=1e-4)


def test_zero_size_box_pinned():
    """A zero-size box inside A overlaps it by A's area and has a BEV IoU
    of area / 1e-8 (the union's floor) in both packages. No caller sees
    it: padded boxes are masked before the IoU is read, as NMS does with
    its valid mask (A is kept, the padded box is not)."""
    a, zero = [-3, 0, 0, 6, 2, 1, 0], [-2, 0.5, 0, 0, 0, 0, 0]
    got = both(a, zero)
    for f in FUNCS:
        assert got[f][0] == pytest.approx(got[f][1], rel=1e-6), f
    assert got["boxes_overlap_bev"][1] == pytest.approx(12.0, rel=1e-5)
    assert got["boxes_iou_bev"][1] == pytest.approx(1.2e9, rel=1e-5)
    boxes = torch.tensor([[zero, a]], dtype=torch.float32)
    keep, mask = nms.nms_bev(boxes, torch.tensor([[0.9, 0.5]]), 0.1, post_maxsize=2,
                             valid_mask=torch.tensor([[False, True]]))
    assert keep[0, 0] == 1 and mask.tolist() == [[True, False]]
