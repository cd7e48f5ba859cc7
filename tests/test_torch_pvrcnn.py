"""PV-RCNN inference, the whole slice: the PyTorch port against the JAX package.

The tiny ``pvrcnn_synthetic.yaml`` (PillarBackBone8x at MAX_PILLARS 2048 on
a 128 x 128 x 16 grid, BF16 False; 256 FPS keypoints from 2048 points; the
VSA's four sources; PointHeadSimple; PVRCNNHead with a 6^3 grid) in f32 on
the CPU. Its weights are a numpy tree with the shapes of JAX's flax tree
(``jax.eval_shape`` of its init), drawn from a seed with BatchNorm
statistics and biases spread, and carried into the port by
``state_dict_from_flax`` (strict). Both run the same test-mode batch. One
JAX forward is shared by the file; besides the whole forward, each module
is run alone in the port on JAX's own inputs. Tolerance: 1e-4 of each
tensor's largest magnitude (f32; sums in another order), FPS keypoints and
masks exact.
"""

import copy

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
from toda_tpu.models.backbones_3d.pfe import voxel_set_abstraction as jvsa
from toda_tpu.models.backbones_3d.pillar_sparse_backbone import ms_features
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
from toda_tpu_torch.runtime import checkpoint
from toda_tpu_torch.tools import test as test_cli
from toda_tpu_torch.weights import init_like_flax_, state_dict_from_flax

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/pvrcnn_synthetic.yaml"
MS_KEYS = ("x_conv3", "x_conv4")
POINT_KEYS = ("point_coords", "point_mask", "point_features_before_fusion", "point_features",
              "point_cls_preds", "point_cls_scores")
HEAD_KEYS = ("spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds")
ROI_KEYS = ("rois", "roi_scores", "roi_labels", "roi_mask", "rcnn_cls", "rcnn_reg")
REL = 1e-4


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def runs():
    """JAX's forward (outputs, the VSA's inputs, detections), the tree,
    the batch and the port's bundle with the tree loaded."""
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
        ms = {k: dict(features=ms_features(e), coords=e["coords"], mask=e["mask"],
                      stride=e["stride"])
              for k, e in out["multi_scale_3d_features"].items() if k in MS_KEYS}
        keep = {k: out[k] for k in POINT_KEYS + HEAD_KEYS + ROI_KEYS + ("spatial_features",)}
        return keep, ms, jb.post_processing(out)

    jout, jms, jdets = jax.device_get(jrun(jax.tree_util.tree_map(jnp.asarray, tree), arrays))

    pcfg = cfg_from_yaml_file(CFG, EDict())
    pb = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                       build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES), device="cpu")
    pb.module.load_state_dict(state_dict_from_flax(tree, pb.module), strict=True)
    out = pb.forward(pb.to_device(batch))
    return dict(jout=jout, jms=jms, jdets=jdets, out=out, tree=tree, batch=batch, pb=pb,
                pdets={k: v.numpy() for k, v in pb.post_processing(out).items()})


def assert_close_to_max(got, want, name, rel=REL):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def jax_inputs(runs):
    """The VSA's and heads' inputs as JAX computed them, as port tensors."""
    j = runs["jout"]
    d = {"points": torch.from_numpy(np.asarray(runs["batch"]["points"], np.float32)),
         "points_mask": torch.from_numpy(np.asarray(runs["batch"]["points_mask"])),
         "spatial_features": nchw(j["spatial_features"]), "spatial_features_stride": 8,
         "multi_scale_3d_features": {
             k: {"features": torch.from_numpy(np.array(e["features"])),
                 "coords": torch.from_numpy(np.array(e["coords"])),
                 "mask": torch.from_numpy(np.array(e["mask"])), "stride": int(e["stride"])}
             for k, e in runs["jms"].items()}}
    for k in POINT_KEYS + ROI_KEYS:
        d[k] = torch.from_numpy(np.array(j[k]))
    return d


def test_backbone_multi_scale_features_match_jax(runs):
    """x_conv3 and x_conv4, the applied stage outputs (B, P, nz, C) with
    their coords and masks; no other stage is kept."""
    ms = runs["out"]["multi_scale_3d_features"]
    assert set(ms) == set(MS_KEYS)
    for k in MS_KEYS:
        for f in ("coords", "mask"):
            np.testing.assert_array_equal(ms[k][f].numpy(), np.asarray(runs["jms"][k][f]))
        assert ms[k]["stride"] == int(runs["jms"][k]["stride"])
        assert_close_to_max(ms[k]["features"].numpy(), runs["jms"][k]["features"], k)
        assert ms[k]["mask"].any()


def test_bilinear_interpolate_clamps_at_the_map_edge():
    """Samples inside, on and past every edge of a 5 x 7 map, against JAX's
    sampler on the channels-last map."""
    rng = np.random.RandomState(0)
    im = rng.normal(size=(3, 5, 7)).astype(np.float32)
    x = np.array([0.0, 0.3, 3.5, 5.99, 6.0, 6.4, 7.5, -0.5, 2.0, 6.7], np.float32)
    y = np.array([0.0, 4.0, 2.2, 3.99, 4.0, 4.6, -1.0, 1.5, 5.5, 0.1], np.float32)
    want = np.asarray(jvsa.bilinear_interpolate(jnp.asarray(im.transpose(1, 2, 0)),
                                                jnp.asarray(x), jnp.asarray(y)))
    got = vsa.bilinear_interpolate(torch.from_numpy(im), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sa_group_msg_matches_jax(runs):
    """The VSA's x_conv4 SAGroupMSG alone, on the JAX forward's x_conv4
    points and keypoints, with the tree's weights."""
    sub = {c: runs["tree"][c]["pfe"]["sa_x_conv4"] for c in ("params", "batch_stats")}
    sa_cfg = runs["pb"].model_cfg["PFE"]["SA_LAYER"]["x_conv4"]
    e = runs["jms"]["x_conv4"]
    xyz, f, m = jvsa._voxel_source_points(
        {k: jnp.asarray(v) for k, v in e.items()}, runs["pb"].meta.voxel_size,
        runs["pb"].meta.point_cloud_range, runs["pb"].meta.grid_size[2])
    kp, kpm = runs["jout"]["point_coords"], runs["jout"]["point_mask"]
    sa = jvsa.SAGroupMSG(mlps=tuple(tuple(v) for v in sa_cfg["MLPS"]),
                         radii=tuple(sa_cfg["POOL_RADIUS"]), nsamples=tuple(sa_cfg["NSAMPLE"]))
    want = jit_o0(sa.apply)(sub, xyz, m, f, jnp.asarray(kp), jnp.asarray(kpm))
    t = [torch.from_numpy(np.array(a)) for a in (xyz, m, f, kp, kpm)]
    with torch.inference_mode():
        got = runs["pb"].module.pfe.sa_x_conv4(*t)
    assert_close_to_max(got.numpy(), want, "sa_x_conv4")
    assert (np.asarray(want) != 0).any(axis=-1).mean() > 0.5


def test_voxel_set_abstraction_matches_jax(runs):
    """The port's VSA on JAX's BEV map and stage outputs: the keypoints and
    their mask exactly, the features before and after fusion to 1e-4."""
    with torch.inference_mode():
        out = runs["pb"].module.pfe(jax_inputs(runs))
    j = runs["jout"]
    np.testing.assert_array_equal(out["point_coords"].numpy(), np.asarray(j["point_coords"]))
    np.testing.assert_array_equal(out["point_mask"].numpy(), np.asarray(j["point_mask"]))
    for k in ("point_features_before_fusion", "point_features"):
        assert_close_to_max(out[k].numpy(), j[k], k)


def test_point_head_simple_matches_jax(runs):
    """PointHeadSimple on JAX's features before fusion."""
    with torch.inference_mode():
        out = runs["pb"].module.point_head(jax_inputs(runs))
    for k in ("point_cls_preds", "point_cls_scores"):
        assert_close_to_max(out[k].numpy(), runs["jout"][k], k)


def test_pvrcnn_head_on_jax_rois_matches_jax(runs):
    """PVRCNNHead's RoI grid pooling and FCs on JAX's RoIs and keypoints."""
    with torch.inference_mode():
        out = runs["pb"].module.roi_head(jax_inputs(runs))
    for k in ("rcnn_cls", "rcnn_reg"):
        assert_close_to_max(out[k].numpy(), runs["jout"][k], k)


def test_whole_forward_matches_jax(runs):
    """The whole forward: the keypoint and head outputs to 1e-4 of each
    tensor's largest magnitude (keypoints and masks exactly), the proposal
    NMS's RoIs as sets."""
    out, j = runs["out"], runs["jout"]
    for k in POINT_KEYS + HEAD_KEYS:
        got = out[k].permute(0, 2, 3, 1) if k == "spatial_features_2d" else out[k]
        if k in ("point_coords", "point_mask"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(j[k]), err_msg=k)
        else:
            assert_close_to_max(got.numpy(), j[k], k)
    for b in range(2):
        jm, pm = np.asarray(j["roi_mask"][b]), out["roi_mask"][b].numpy()
        assert jm.sum() == pm.sum() > 0

        def rows(o, m):
            r = np.concatenate([np.asarray(o["rois"][b])[m], np.asarray(o["roi_scores"][b])[m, None],
                                np.asarray(o["roi_labels"][b])[m, None]], 1)
            return r[np.lexsort(r.T[::-1])]

        np.testing.assert_allclose(rows({k: out[k].numpy() for k in ROI_KEYS}, pm), rows(j, jm),
                                   rtol=1e-4, atol=1e-4)


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


def test_voxel_centres_in_f32_repair():
    """F12: JAX computes the VSA's voxel centres in the features' dtype, so
    under BF16 the integer coords and the centres round in bf16: at x_conv3's
    stride 4 on the Waymo range, coords 257 and 375 give x = 27.5 and 76.0
    (the second past the range's 75.2) where the centres are 27.8 and 75.0.
    The port computes them in f32 whatever the features' dtype; on f32
    features it equals JAX."""
    voxel, pc_range = (0.1, 0.1, 0.15), (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
    coords = np.array([[[0, 257], [0, 375]]], np.int32)
    feats = np.ones((1, 2, 10, 4), np.float32)
    mask = np.ones((1, 2), bool)
    entry = {"coords": coords, "mask": mask, "stride": 4}
    want = np.array([27.8, 75.0], np.float32)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jxyz = np.asarray(jvsa._voxel_source_points(
            {**{k: jnp.asarray(v) for k, v in entry.items()},
             "features": jnp.asarray(feats, dtype=jdt)}, voxel, pc_range, 40)[0], np.float32)
        pxyz, pf, pm = vsa._voxel_source_points(
            {**{k: torch.from_numpy(np.asarray(v)) for k, v in entry.items() if k != "stride"},
             "stride": 4, "features": torch.from_numpy(feats).to(dtype)}, voxel, pc_range, 40)
        assert pxyz.dtype == pf.dtype == torch.float32 and pxyz.shape == (1, 20, 3)
        np.testing.assert_allclose(pxyz[0, ::10, 0].numpy(), want, rtol=0, atol=1e-5)
        if dtype == torch.float32:
            np.testing.assert_array_equal(pxyz.numpy(), jxyz)
        else:  # JAX's bf16 centres, a quarter and a whole metre off
            np.testing.assert_array_equal(jxyz[0, ::10, 0], [27.5, 76.0])
            assert np.abs(jxyz - pxyz.numpy()).max() >= 1.0


def test_test_cli_evaluates_pvrcnn(runs, tmp_path, monkeypatch):
    """``toda_tpu_torch.tools.test`` builds pvrcnn_synthetic.yaml on the
    SyntheticDataset and evaluates a checkpoint of the carried weights
    through ``eval_one_epoch``: recall of the RoIs and of the detections."""
    from toda_tpu_torch.config import cfg as port_cfg

    monkeypatch.setattr(port_cfg, "ROOT_DIR", tmp_path)
    ckpt = tmp_path / "checkpoint_epoch_1.pth"
    torch.save({"model": runs["pb"].module.state_dict(), "epoch": 1}, ckpt)
    result = test_cli.main(["--cfg_file", CFG, "--ckpt", str(ckpt), "--batch_size", "2",
                            "--device", "cpu", "--set", "DATA_CONFIG.NUM_SCENES", "2"])
    for k in ("recall/roi_0.3", "recall/0.3", "mAP"):
        assert np.isfinite(result[k]), (k, result)
    assert checkpoint.load_weights(ckpt).keys() == runs["pb"].module.state_dict().keys()


def test_init_like_flax_pvrcnn_heads(runs):
    """``init_like_flax_`` (``build_network``'s init) gives PVRCNNHead's
    ``reg_out`` flax's normal(0.001) kernel and ``cls_out`` its
    xavier-normal one, and the SA, fusion, point-head and FC layers LeCun
    normal kernels (std fan_in^-1/2), every bias zero."""
    m = init_like_flax_(copy.deepcopy(runs["pb"].module), 3).requires_grad_(False)
    head = m.roi_head
    assert abs(float(head.reg_out.weight.std()) / 0.001 - 1) < 0.1
    fan_in, fan_out = head.cls_out.in_features, head.cls_out.out_features
    assert abs(float(head.cls_out.weight.std()) / (2 / (fan_in + fan_out)) ** 0.5 - 1) < 0.2
    for lin in (m.pfe.sa_x_conv3.g1_fc0, m.pfe.fusion_fc, m.point_head.cls_fc0,
                head.shared_fc0, head.roi_grid_pool.g0_fc1):
        assert abs(float(lin.weight.std()) * lin.in_features ** 0.5 - 1) < 0.1
    assert all((lin.bias == 0).all() for lin in (head.cls_out, head.reg_out,
                                                  m.point_head.cls_out))
