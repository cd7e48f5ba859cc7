"""PartA2 inference, the whole slice: the PyTorch port against the JAX package.

The tiny ``parta2_synthetic.yaml`` (UNetV2 at MAX_PILLARS 1024, 16 z cells,
so ``conv_out`` pads its depth of 2 as flax's SAME does, (0, 1)) in f32 on
the CPU. Its weights are a numpy tree with the shapes of JAX's flax tree
(``jax.eval_shape`` of its init), drawn from a seed with BatchNorm
statistics and biases spread so that no two scores tie, and carried into the
port by ``state_dict_from_flax``. Both run the same test-mode batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jit_o0, random_tree

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.models import build_network as j_build_network
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.weights import state_dict_from_flax

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/parta2_synthetic.yaml"
POINT_KEYS = ("point_features", "point_coords", "point_mask", "point_cls_scores",
              "point_part_offset")
HEAD_KEYS = ("spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds")
ROI_KEYS = ("rois", "roi_scores", "roi_labels", "roi_mask", "rcnn_cls", "rcnn_reg")


@pytest.fixture(scope="module")
def runs():
    """JAX's forward outputs and detections, the port's, and the port's RoI
    head run on JAX's RoIs and point outputs."""
    np.random.seed(0)
    jcfg = j_cfg_from_yaml_file(CFG, JEDict())
    jds, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                         training=False)
    batch = next(iter(jloader))
    arrays = {"points": jnp.asarray(batch["points"]),
              "points_mask": jnp.asarray(batch["points_mask"])}
    jb = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=jds)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jb.module.init(
        {"params": key, "sampling": key, "dropout": key}, b, training=False), arrays)
    tree = random_tree(dict(shapes), np.random.RandomState(1))

    @jit_o0
    def jrun(variables, b):
        out = jb.module.apply(variables, b, training=False)
        return {k: out[k] for k in POINT_KEYS + HEAD_KEYS + ROI_KEYS}, jb.post_processing(out)

    jout, jdets = jax.device_get(jrun(jax.tree_util.tree_map(jnp.asarray, tree), arrays))

    pcfg = cfg_from_yaml_file(CFG, EDict())
    pb = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                       build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES), device="cpu")
    pb.module.load_state_dict(state_dict_from_flax(tree, pb.module), strict=True)
    out = pb.forward(pb.to_device(batch))
    pout = {k: v.numpy() for k, v in out.items() if k in POINT_KEYS + HEAD_KEYS + ROI_KEYS}
    pout["spatial_features_2d"] = out["spatial_features_2d"].permute(0, 2, 3, 1).numpy()
    pdets = {k: v.numpy() for k, v in pb.post_processing(out).items()}
    with torch.inference_mode():
        head_in = {k: torch.from_numpy(np.array(jout[k]))
                   for k in POINT_KEYS + ("rois", "roi_mask")}
        on_jax_rois = pb.module.roi_head(head_in)
    return dict(jout=jout, jdets=jdets, pout=pout, pdets=pdets,
                rcnn={k: on_jax_rois[k].numpy() for k in ("rcnn_cls", "rcnn_reg")})


def assert_close_to_max(got, want, rel, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def test_point_and_dense_head_outputs_match_jax(runs):
    """UNetV2's point outputs, the BEV features and the anchor head maps, to
    1e-4 of each tensor's largest magnitude."""
    for k in POINT_KEYS + HEAD_KEYS:
        assert_close_to_max(runs["pout"][k], runs["jout"][k], 1e-4, k)
    assert 0 < runs["pout"]["point_mask"].mean() < 1


def test_proposals_equal_jax_as_sets(runs):
    """The proposal NMS keeps the same RoIs (boxes, scores, labels), in any
    order."""
    jout, pout = runs["jout"], runs["pout"]
    for b in range(jout["rois"].shape[0]):
        jm, pm = np.asarray(jout["roi_mask"][b]), pout["roi_mask"][b]
        assert jm.sum() == pm.sum() > 0

        def rows(o, m):
            r = np.concatenate([np.asarray(o["rois"][b])[m], np.asarray(o["roi_scores"][b])[m, None],
                                np.asarray(o["roi_labels"][b])[m, None]], 1)
            return r[np.lexsort(r.T[::-1])]

        np.testing.assert_allclose(rows(pout, pm), rows(jout, jm), rtol=1e-4, atol=1e-4)


def test_roi_head_on_jax_rois_matches_jax(runs):
    """PartA2FCHead on JAX's RoIs and point outputs: rcnn_cls and rcnn_reg
    to 1e-4 of each tensor's largest magnitude."""
    for k in ("rcnn_cls", "rcnn_reg"):
        assert_close_to_max(runs["rcnn"][k], runs["jout"][k], 1e-4, k)


def test_final_detections_equal_jax(runs):
    """The final NMS keeps the same detections where the scores are apart
    by more than 1e-5 (closer scores may rank either way); RoIs ride
    along."""
    jd, pd = runs["jdets"], runs["pdets"]
    np.testing.assert_array_equal(pd["roi_mask"], np.asarray(jd["roi_mask"]))
    for b in range(jd["pred_mask"].shape[0]):
        jm, pm = np.asarray(jd["pred_mask"][b]), pd["pred_mask"][b]
        assert jm.sum() == pm.sum() > 0
        js, ps = np.asarray(jd["pred_scores"][b])[jm], pd["pred_scores"][b][pm]
        gaps = np.abs(js[:, None] - js[None, :]) + np.eye(len(js))
        apart = gaps.min(1) > 1e-5
        for bx_j, sc_j in zip(np.asarray(jd["pred_boxes"][b])[jm][apart], js[apart]):
            d = np.abs(pd["pred_boxes"][b][pm] - bx_j).max(1) + np.abs(ps - sc_j)
            assert d.min() <= 1e-4, d.min()
        assert apart.sum() > 0
