"""The whole CenterPoint-Res slice: the PyTorch port against the JAX package.

A tiny CenterPoint-Res (the ``__graft_entry__`` tiny widths, with
CHANNELS[0] = 16 so stage 1's residual projection 8 -> 16 runs as at full
width) gets random numpy weights, BatchNorm statistics included, in the flax
tree; ``state_dict_from_flax`` carries them into the port. Both run the same
test-mode batch on the CPU. In f32: BEV features and every head output agree
to 1e-3, the decoded top-K boxes and scores to 1e-3, and the post-NMS kept
sets are equal. ``test_torch_model_bf16.py`` holds a bf16 run to a loose bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.models import build_network as j_build_network
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.utils.common_utils import resolve_device
from toda_tpu_torch.weights import state_dict_from_flax

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/centerpoint_synthetic.yaml"


def tiny(cfg, bf16):
    d = cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    d.DATA_PROCESSOR[2].NUM_POINTS = {"train": 1024, "test": 1024}
    d.DATA_PROCESSOR[3].VOXEL_SIZE = [0.5, 0.5, 0.5]
    d.DATA_PROCESSOR[3].MAX_NUMBER_OF_VOXELS = {"train": 1024, "test": 1024}
    d.NUM_SCENES = 2
    d.NUM_OBJECTS = [2, 4]
    m = cfg.MODEL
    m.BACKBONE_3D.CHANNELS = [16, 16, 16, 16]
    m.BACKBONE_3D.MAX_PILLARS = 1024
    m.BACKBONE_3D.BF16 = bf16
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.BACKBONE_2D.LAYER_STRIDES = [1, 2]
    m.BACKBONE_2D.NUM_FILTERS = [16, 32]
    m.BACKBONE_2D.UPSAMPLE_STRIDES = [1, 2]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    return cfg


def random_tree(shapes, rng):
    """numpy leaves for a flax variable tree: He-normal kernels, BatchNorm
    scale U(0.5, 1.5), biases and means N(0, 0.1), variances U(0.5, 1.5)."""
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = random_tree(v, rng)
            continue
        shape = v.shape
        if k in ("kernel", "proj_kernel"):
            val = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif k in ("scale", "var"):
            val = rng.uniform(0.5, 1.5, shape)
        elif k in ("bias", "mean"):
            val = rng.normal(0.0, 0.1, shape)
        else:
            raise KeyError(k)
        out[k] = val.astype(np.float32)
    return out


def run_both(bf16, decode=True):
    """(JAX outputs, port outputs): BEV features, head outputs and, with
    ``decode``, the decoded top-K and the post-NMS detections."""
    np.random.seed(0)
    jcfg = tiny(j_cfg_from_yaml_file(CFG, JEDict()), bf16)
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

    @jax.jit
    def jrun(variables, b):
        out = jb.module.apply(variables, b, training=False)
        head = (out["spatial_features_2d"], out["center_pred_dicts"][0])
        return head + ((jb._center_decode(out), jb.post_processing(out)) if decode else ())

    jout = jax.device_get(jrun(jax.tree_util.tree_map(jnp.asarray, tree), arrays))

    pcfg = tiny(cfg_from_yaml_file(CFG, EDict()), bf16)
    pb = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                       build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES), device="cpu")
    pb.module.load_state_dict(state_dict_from_flax(tree, pb.module), strict=True)
    out = pb.forward(pb.to_device(batch))
    pout = (out["spatial_features_2d"].permute(0, 2, 3, 1).numpy(),
            {k: v.permute(0, 2, 3, 1).numpy() for k, v in out["center_pred_dicts"][0].items()})
    if decode:
        pout += (tuple(v.numpy() for v in pb.decode(out)),
                 {k: v.numpy() for k, v in pb.post_processing(out).items()})
    return jout, pout


def assert_same_rows(a, b, tol):
    """Rows of a and b agree to tol up to order (near-equal scores may rank
    either way): each row of a has a distinct partner in b."""
    assert a.shape == b.shape
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    assert (d.min(1) <= tol).all(), d.min(1).max()
    assert len(set(d.argmin(1).tolist())) == len(a)


@pytest.fixture(scope="module")
def f32_outputs():
    return run_both(bf16=False)


def test_f32_features_and_head_outputs(f32_outputs):
    (jsf, jheads, _, _), (psf, pheads, _, _) = f32_outputs
    np.testing.assert_allclose(psf, np.asarray(jsf), rtol=1e-3, atol=1e-3)
    assert set(pheads) == set(jheads) == {"hm", "center", "center_z", "dim", "rot"}
    for k in jheads:
        np.testing.assert_allclose(pheads[k], np.asarray(jheads[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_f32_decoded_topk(f32_outputs):
    (_, _, (jbox, jscore, jlab), _), (_, _, (pbox, pscore, plab), _) = f32_outputs
    for b in range(jbox.shape[0]):
        rows_j = np.concatenate([jbox[b], jscore[b][:, None], jlab[b][:, None]], axis=1)
        rows_p = np.concatenate([pbox[b], pscore[b][:, None], plab[b][:, None]], axis=1)
        assert_same_rows(rows_p, rows_j, 1e-3)
    np.testing.assert_allclose(pscore, np.asarray(jscore), rtol=1e-3, atol=1e-3)


def test_f32_post_nms_kept_sets_equal(f32_outputs):
    (_, _, _, jd), (_, _, _, pd) = f32_outputs
    for b in range(jd["pred_mask"].shape[0]):
        jm, pm = np.asarray(jd["pred_mask"][b]), pd["pred_mask"][b]
        assert jm.sum() == pm.sum() > 0
        rows_j = np.concatenate([jd["pred_boxes"][b][jm], jd["pred_labels"][b][jm][:, None]], 1)
        rows_p = np.concatenate([pd["pred_boxes"][b][pm], pd["pred_labels"][b][pm][:, None]], 1)
        assert_same_rows(rows_p, rows_j, 1e-3)


def test_entry_points_refuse_to_fall_back_to_cpu():
    """Without a CUDA device an entry point asked for the default device
    raises; it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        assert resolve_device("cpu").type == "cpu"
