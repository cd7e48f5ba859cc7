"""SECOND, the whole slice: the PyTorch port against the JAX package.

A tiny SECOND from ``second_synthetic.yaml`` (``chip_smoke.second_tiny``:
range [-16, 16]^2 x [-3, 1], voxel 0.5, a few hundred pillars, CHANNELS
[16, 32, 32, 32], f32; the card's run holds the same model cuda against
cpu) with ``FUSED_CONV: False``, so its backbone runs the transposed layout's
``pillar_conv3d_t`` (K7 and K8) as JAX's does. Its weights are a numpy tree
with the shapes of JAX's flax tree (``jax.eval_shape`` of its init) drawn
from a seed (for training, with flax's constant initial values), carried
into the port by ``state_dict_from_flax``. Inference:
the BEV features and the anchor head's outputs, the kept detections and the
top-K decode against JAX's on one test-mode batch, and the port's fused
contract (``FUSED_CONV: True``, kernels K1-K3) against the same JAX run.
Training: three ``make_train_step`` steps on one augmented batch against
JAX's, held as ``test_torch_train.py`` holds CenterPoint-Res (targets,
step-1 gradients, losses, updates and BatchNorm statistics). And the
legacy contract of CenterPoint-Res's residual backbone against its fused
one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import second_tiny, update_mismatches
from test_torch_model import CFG as CENTERPOINT_CFG
from test_torch_model import random_tree, tiny
from test_torch_parta2 import assert_close_to_max

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.models import build_network as j_build_network
from toda_tpu.runtime import optimization as j_optimization
from toda_tpu.runtime import train_utils as j_train_utils
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.runtime import train_utils
from toda_tpu_torch.weights import randomize_, state_dict_from_flax

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/second_synthetic.yaml"
HEAD_KEYS = ("spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds")
STEPS = 3
TOTAL_STEPS = 10  # the schedules' length: the 3 steps climb the OneCycle warm-up


def _port(fused, training=False):
    pcfg = second_tiny(cfg_from_yaml_file(CFG, EDict()), fused)
    return pcfg, build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                               build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES,
                                             training=training), device="cpu")


def _jax_setup(training):
    np.random.seed(0)
    jcfg = second_tiny(j_cfg_from_yaml_file(CFG, JEDict()))
    jds, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                         training=training)
    batch = next(iter(jloader))
    arrays = {k: jnp.asarray(v) for k, v in j_train_utils.select_batch_arrays(batch).items()}
    jb = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=jds)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jb.module.init(
        {"params": key, "sampling": key, "dropout": key}, b, training=False), arrays)
    tree = random_tree(dict(shapes), np.random.RandomState(1))
    return jcfg, jb, batch, arrays, tree


@pytest.fixture(scope="module")
def infer():
    """JAX's outputs, detections and top-K, and the port's on both
    contracts, on one test-mode batch."""
    _, jb, batch, arrays, tree = _jax_setup(training=False)

    @jax.jit
    def jrun(variables, b):
        out = jb.module.apply(variables, b, training=False)
        return {k: out[k] for k in HEAD_KEYS}, jb.post_processing(out), jb.decode_topk(out, 16)

    jout, jdets, jtop = jax.device_get(jrun(jax.tree_util.tree_map(jnp.asarray, tree), arrays))
    ports = {}
    for fused in (False, True):
        _, pb = _port(fused)
        pb.module.load_state_dict(state_dict_from_flax(tree, pb.module), strict=True)
        out = pb.forward(pb.to_device(batch))
        pout = {k: out[k].numpy() for k in HEAD_KEYS}
        pout["spatial_features_2d"] = out["spatial_features_2d"].permute(0, 2, 3, 1).numpy()
        dets = {k: v.numpy() for k, v in pb.post_processing(out).items()}
        ports[fused] = dict(out=pout, dets=dets,
                            top=tuple(v.numpy() for v in pb.decode_topk(out, 16)))
    return dict(jout=jout, jdets=jdets, jtop=jtop, ports=ports)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_outputs_match_jax(infer, fused):
    """The BEV features and the anchor head's class, box and direction
    outputs to 1e-4 of each tensor's largest magnitude, on the legacy
    contract (the transposed layout's K7 / K8 convs, as JAX runs it) and on
    the fused one (K1), which computes the same function."""
    for k in HEAD_KEYS:
        assert_close_to_max(infer["ports"][fused]["out"][k], infer["jout"][k], 1e-4, k)


def test_post_processing_keeps_the_same_detections(infer):
    """The anchor-only post-processing (decode of every anchor, best class,
    NMS) keeps the same boxes, scores and labels, in any order."""
    jd, pd = infer["jdets"], infer["ports"][False]["dets"]
    for b in range(jd["pred_mask"].shape[0]):
        jm, pm = np.asarray(jd["pred_mask"][b]), pd["pred_mask"][b]
        assert jm.sum() == pm.sum() > 0

        def rows(d, m):
            r = np.concatenate([np.asarray(d["pred_boxes"][b])[m],
                                np.asarray(d["pred_scores"][b])[m, None],
                                np.asarray(d["pred_labels"][b])[m, None]], 1)
            return r[np.lexsort(r.T[::-1])]

        np.testing.assert_allclose(rows(pd, pm), rows(jd, jm), rtol=1e-4, atol=1e-4)


def test_decode_topk_matches_jax(infer):
    """``decode_topk``: the 16 best anchors' boxes and scores."""
    (jbox, jscore), (pbox, pscore) = infer["jtop"], infer["ports"][False]["top"]
    np.testing.assert_allclose(pscore, np.asarray(jscore), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pbox, np.asarray(jbox), rtol=1e-4, atol=1e-4)


def flax_init_tree(tree, owner=None):
    """``tree`` with flax's initial values where flax's initialisers are
    constants: BatchNorm scale 1 and bias 0, statistics 0 and 1, conv
    biases 0 but the class conv's focal-loss prior; the kernels stay
    He-normal. Three Adam steps from ``random_tree``'s spread BatchNorm
    weights drift apart on the port's own two conv contracts (f32 both,
    sums in another order) by more than the update check's tolerance, so
    from there the check measures the trajectory's sensitivity; from these
    values the two stay well inside it, as CenterPoint-Res from JAX's own
    init does."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = flax_init_tree(v, k)
        elif k in ("scale", "var"):
            out[k] = np.ones_like(v)
        elif k == "mean" or (k == "bias" and owner != "conv_cls"):
            out[k] = np.zeros_like(v)
        elif k == "bias":
            out[k] = np.full_like(v, -np.log((1 - 0.01) / 0.01))
        else:
            out[k] = v
    return out


def _port_steps(fused, init, batch, steps=STEPS):
    """``steps`` port ``make_train_step`` steps from ``init``: the losses,
    the first step's gradients, the final state dict, the sum of the
    steps' LRs and the bundle."""
    pcfg, pb = _port(fused, training=True)
    pb.module.load_state_dict(init, strict=True)
    pstate, _ = train_utils.create_train_state(pb, pcfg.OPTIMIZATION, TOTAL_STEPS)
    pstep = train_utils.make_train_step(pb)
    losses, grads = [], None
    for _ in range(steps):
        pstate, tb = pstep(pstate, batch)
        losses.append({k: float(v) for k, v in tb.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in pb.module.named_parameters()}
    return dict(losses=losses, grads=grads, final=pb.module.state_dict(), bundle=pb,
                lr_sum=sum(pstate.lr_fn(s) for s in range(steps)))


@pytest.fixture(scope="module")
def train():
    """Three JAX ``make_train_step`` steps from flax's initial values
    (``flax_init_tree``) on one augmented training batch, JAX's step-1 gradients and targets, and the
    port's three steps (legacy contract) and first step (fused contract)
    from the same weights."""
    jcfg, jb, batch, arrays, tree = _jax_setup(training=True)
    tree = flax_init_tree(tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])
    tx, _ = j_optimization.build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
    state = j_train_utils.TrainState.create(apply_fn=jb.module.apply, params=params, tx=tx,
                                            batch_stats=stats)
    port_module = _port(False)[1].module
    init = state_dict_from_flax(tree, port_module)
    jgrads = jax.jit(jax.grad(lambda p: jb.loss(
        {"params": p, "batch_stats": stats}, dict(arrays, batch_size=2))[0]))(params)
    jtargets = jax.device_get(jb.assigner.assign(arrays["gt_boxes"]))
    jstep = j_train_utils.make_train_step(jb)
    jlosses = []
    for _ in range(STEPS):
        state, tb = jstep(state, arrays)
        jlosses.append({k: float(v) for k, v in tb.items()})
    final = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}

    port = _port_steps(False, init, batch)
    ptargets = port["bundle"].assigner.assign(torch.as_tensor(np.asarray(batch["gt_boxes"])))
    return dict(
        jgrads=state_dict_from_flax({"params": jax.device_get(jgrads)}, port_module),
        jlosses=jlosses, jtargets=jtargets, jfinal=state_dict_from_flax(final, port_module),
        port=port, ptargets=ptargets, fused=_port_steps(True, init, batch, steps=1),
        init=init)


def test_targets_equal_jax(train):
    """The assigner's labels integer-equal on the augmented batch, the
    regression targets and weights to 1e-6."""
    j, p = train["jtargets"], train["ptargets"]
    labels = p["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, j["box_cls_labels"])
    assert (labels > 0).any()
    for k in ("box_reg_targets", "reg_weights", "matched_gt_heading"):
        np.testing.assert_allclose(p[k].numpy(), j[k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("contract", ["legacy", "fused"])
def test_step1_gradients_equal_jax(train, contract):
    """Every parameter's gradient of the first step agrees with JAX's to
    1e-3 of that parameter's largest |gradient| (f32; sums in another
    order), on either conv contract of the backbone."""
    jg = train["jgrads"]
    pg = train["port" if contract == "legacy" else "fused"]["grads"]
    assert set(jg) == set(pg)
    for name, want in jg.items():
        scale = max(float(want.abs().max()), 1e-12)
        err = float((pg[name] - want).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


def test_three_step_losses_equal_jax(train):
    """Each loss term of each of the three steps agrees to 1e-3 relative."""
    for j, p in zip(train["jlosses"], train["port"]["losses"]):
        assert set(j) == set(p) == {"loss", "rpn_loss", "rpn_loss_cls", "rpn_loss_loc",
                                    "rpn_loss_dir"}
        for k in j:
            assert abs(p[k] - j[k]) <= 1e-3 * abs(j[k]), (k, p[k], j[k])
    assert train["fused"]["losses"][0]["loss"] == pytest.approx(train["jlosses"][0]["loss"],
                                                                rel=1e-3)


def test_params_and_running_stats_after_three_steps_equal_jax(train):
    """After three steps each parameter's update agrees with JAX's as
    ``chip_smoke.update_mismatches`` holds it; BatchNorm running statistics
    to 1e-4; every parameter moved."""
    jf, pf, init = train["jfinal"], train["port"]["final"], train["init"]
    assert update_mismatches(pf, jf, init, train["jgrads"], train["port"]["lr_sum"])[0] == []
    for name, want in jf.items():
        got = pf[name].float()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        elif not name.endswith("num_batches_tracked"):
            assert not torch.equal(got, init[name]), name


def test_centerpoint_res_legacy_contract_matches_fused():
    """CenterPoint-Res's residual backbone on the legacy contract
    (``FUSED_CONV: False``: the transposed layout's convs, BatchNorm applied
    per layer, the residual joins and stage 1's 8 -> 16 projection) builds,
    loads the fused contract's weights and gives its BEV features to 1e-5
    of their largest magnitude."""
    np.random.seed(0)
    feats = []
    for fused in (True, False):
        cfg = tiny(cfg_from_yaml_file(CENTERPOINT_CFG, EDict()), False)
        cfg.MODEL.BACKBONE_3D.FUSED_CONV = fused
        ds = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
        pb = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
        if fused:
            weights = randomize_(pb.module, 0).state_dict()
            batch = ds.collate_batch([ds[0], ds[1]])
        pb.module.load_state_dict(weights, strict=True)
        feats.append(pb.forward(pb.to_device(batch))["spatial_features_2d"].numpy())
    assert_close_to_max(feats[1], feats[0], 1e-5, "spatial_features_2d")
