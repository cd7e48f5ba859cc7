"""The TODA stages on the tiny CenterPoint-Res: the PyTorch port against the
JAX package on the CPU, in f32.

The pseudo-label perturbation's gradient of the eval-mode loss with respect
to the raw points (``loss(..., training=False)``: running statistics, none
updated); ``decode_topk`` and its gradient into the head outputs; the
consistency loss's box reversal and matching; and one stage-2
``make_train_step_cl`` step (two forwards, both detection losses, the top-K
consistency term, one AdamW update) against JAX's. The JAX weights are the
flax tree's shapes (``jax.eval_shape``) filled with numpy
(``test_torch_model.random_tree``), carried into the port by
``state_dict_from_flax``. JAX's programs here are compiled at -O0
(``test_torch_model.XLA_O0``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import update_mismatches
from test_torch_model import CFG, XLA_O0, jit_o0, random_tree, tiny, vjp_o0

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.datasets.dataset_cl import CLPairDataset as JCLPairDataset
from toda_tpu.models import build_network as j_build_network
from toda_tpu.models import consistency as j_consistency
from toda_tpu.runtime import train_cl as j_train_cl
from toda_tpu.runtime.optimization import build_optimizer as j_build_optimizer
from toda_tpu.runtime.train_utils import TrainState
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.models import consistency
from toda_tpu_torch.runtime import pseudo_label, train_cl, train_utils
from toda_tpu_torch.weights import state_dict_from_flax

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

TOTAL_STEPS = 10


@pytest.fixture(scope="module")
def model():
    """JAX bundle, random flax tree, the port bundle with the same weights,
    and a training batch of each kind (test batch with its gt boxes; the
    dual batch of ``CLPairDataset``)."""
    np.random.seed(0)
    jcfg = tiny(j_cfg_from_yaml_file(CFG, JEDict()), False)
    jds, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                         training=False)
    batch = next(iter(jloader))
    arrays = {k: jnp.asarray(batch[k]) for k in ("points", "points_mask", "gt_boxes")}
    jb = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=jds)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jb.module.init(
        {"params": key, "sampling": key, "dropout": key}, b, training=False), arrays)
    tree = random_tree(dict(shapes), np.random.RandomState(1))

    pcfg = tiny(cfg_from_yaml_file(CFG, EDict()), False)
    pb = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                       build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, training=True),
                       device="cpu")
    pb.module.load_state_dict(state_dict_from_flax(tree, pb.module), strict=True)

    np.random.seed(0)
    tds, _, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                   training=True)
    cl = JCLPairDataset(tds)
    cl_batch = cl.collate_batch([cl[i] for i in range(2)])
    return dict(jb=jb, tree=tree, pb=pb, batch=batch, arrays=arrays, cl_batch=cl_batch,
                jcfg=jcfg, pcfg=pcfg)


def test_eval_loss_points_gradient_equals_jax(model):
    """The eval-mode loss (``loss(batch, training=False)``) and its gradient
    with respect to the raw points against ``jax.grad`` of JAX's
    ``loss(..., training=False, mutable=())``: the loss to 1e-5 relative,
    the gradient to 1e-4 of its largest value (f32; sums in another order),
    the signs equal wherever |g| > 1e-3 of the largest, and no BatchNorm
    running statistic moves. The port's ``make_perturb_step`` returns the
    sign of the xyz gradient and leaves every parameter's requires_grad
    as it found it."""
    jb, arrays, pb = model["jb"], model["arrays"], model["pb"]
    variables = jax.tree_util.tree_map(jnp.asarray, model["tree"])

    def jloss(points):
        b = dict(arrays, points=points, batch_size=points.shape[0])
        return jb.loss(variables, b, training=False, mutable=())[0]

    jval, jgrad = jit_o0(jax.value_and_grad(jloss))(arrays["points"])
    jgrad = np.asarray(jgrad)

    before = {k: v.clone() for k, v in pb.module.state_dict().items()}
    batch = pb.to_device(model["batch"])
    points = batch["points"].clone().requires_grad_()
    for p in pb.module.parameters():
        p.requires_grad_(False)
    total, _ = pb.loss(dict(batch, points=points), training=False)
    (grad,) = torch.autograd.grad(total, points)
    for p in pb.module.parameters():
        p.requires_grad_(True)
    assert not pb.module.training
    for k, v in pb.module.state_dict().items():
        assert torch.equal(v, before[k]), k

    assert abs(total.item() - float(jval)) <= 1e-5 * abs(float(jval))
    scale = np.abs(jgrad).max()
    assert scale > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=1e-4 * scale)
    live = np.abs(jgrad[..., :3]) > 1e-3 * scale
    assert live.sum() > 100
    np.testing.assert_array_equal(np.sign(grad.numpy()[..., :3])[live],
                                  np.sign(jgrad[..., :3])[live])
    sign = pseudo_label.make_perturb_step(pb)(model["batch"])
    np.testing.assert_array_equal(sign.numpy(), np.sign(grad.numpy()[..., :3]))
    assert all(p.requires_grad for p in pb.module.parameters())


def test_decode_topk_values_and_gradient_equal_jax(model):
    """``decode_topk`` from the same head maps (random, at the tiny model's
    8 x 8 BEV): the 16 best boxes and scores to 1e-5, and the VJP of a fixed
    cotangent on both into every head map to 1e-5 of its largest value.
    It carries gradients (the stage-2 consistency loss is differentiated
    through it)."""
    jb, pb = model["jb"], model["pb"]
    rng = np.random.RandomState(2)
    widths = {"hm": 1, "center": 2, "center_z": 1, "dim": 3, "rot": 2}
    heads = [{k: jnp.asarray(rng.randn(2, 8, 8, c).astype(np.float32))
              for k, c in widths.items()}]
    cot_b = rng.randn(2, 16, 7).astype(np.float32)
    cot_s = rng.randn(2, 16).astype(np.float32)
    (jboxes, jscores), (jgrads,) = vjp_o0(
        lambda h: jb.decode_topk({"center_pred_dicts": h}, k=16), (heads,),
        (jnp.asarray(cot_b), jnp.asarray(cot_s)))

    pheads = [{k: torch.tensor(np.asarray(v)).permute(0, 3, 1, 2).contiguous()
               .requires_grad_() for k, v in h.items()} for h in heads]
    boxes, scores = pb.decode_topk({"center_pred_dicts": pheads}, k=16)
    assert boxes.requires_grad and scores.requires_grad
    np.testing.assert_allclose(boxes.detach().numpy(), np.asarray(jboxes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(jscores), rtol=1e-5,
                               atol=1e-5)
    ((boxes * torch.from_numpy(cot_b)).sum() + (scores * torch.from_numpy(cot_s)).sum()).backward()
    for k, want in jgrads[0].items():
        want = np.asarray(want)
        got = pheads[0][k].grad.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-6),
                                   err_msg=k)
    assert np.abs(np.asarray(jgrads[0]["hm"])).max() > 0


def test_reverse_boxes_and_consistency_loss_equal_jax():
    """``reverse_boxes`` (flips, rotation, scaling, translation undone) and
    ``consistency_loss`` (nearest confident centre, smooth-L1 centre and L1
    size over the matched pairs) and its gradients in both box sets,
    against JAX to 1e-5, on boxes built so that most pairs match and some
    scores fall under the threshold."""
    rng = np.random.RandomState(3)
    b, k = 3, 24
    base = np.concatenate([rng.uniform(-20, 20, (b, k, 3)), rng.uniform(1, 4, (b, k, 3)),
                           rng.uniform(-np.pi, np.pi, (b, k, 1))], -1).astype(np.float32)
    other = (base + rng.normal(0, 0.6, base.shape)).astype(np.float32)
    other = other[:, rng.permutation(k)]
    sa, sb = rng.uniform(0, 1, (2, b, k)).astype(np.float32)
    aug = np.asarray([[1, 0, 0.3, 1.03, 0, 0, 0], [0, 1, -0.2, 0.97, 0.5, -0.4, 0.1],
                      [1, 1, 0.1, 1.0, 0, 0, 0]], np.float32)
    rev = consistency.reverse_boxes(torch.from_numpy(base), torch.from_numpy(aug))
    np.testing.assert_allclose(rev.numpy(), np.asarray(jit_o0(j_consistency.reverse_boxes_jnp)(
        jnp.asarray(base), jnp.asarray(aug))), rtol=1e-5, atol=1e-5)

    def jloss(a, o):
        c, s = j_consistency.consistency_loss(a, jnp.asarray(sa), o, jnp.asarray(sb), 0.3)
        return c + 2 * s, (c, s)

    (_, (jc, js)), jg = jit_o0(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(base), jnp.asarray(other))
    ta, to = (torch.from_numpy(v).requires_grad_() for v in (base, other))
    c, s = consistency.consistency_loss(ta, torch.from_numpy(sa), to, torch.from_numpy(sb), 0.3)
    (c + 2 * s).backward()
    assert c.item() > 0 and s.item() > 0
    np.testing.assert_allclose([c.item(), s.item()], [float(jc), float(js)], rtol=1e-5)
    for got, want in ((ta.grad, jg[0]), (to.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_cl_train_step_equals_jax(model):
    """One stage-2 ``make_train_step_cl`` step on the same dual batch
    (consistency weight 0.1, score threshold 0 so every top-32 box takes
    part in the matching) from the same weights: the total, both detection
    losses and both consistency terms to 1e-4 relative; each parameter's
    update as ``chip_smoke.update_mismatches`` holds it (1e-3 of the step's
    LR where the port's gradient is live); the BatchNorm running statistics,
    updated by the adv forward and then the org forward, to 1e-4."""
    jb, tree, pb, jcfg = model["jb"], model["tree"], model["pb"], model["jcfg"]
    cl_batch = model["cl_batch"]
    init = {k: v.clone() for k, v in pb.module.state_dict().items()}

    tx, _ = j_build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    state = TrainState.create(apply_fn=jb.module.apply, params=jtree["params"], tx=tx,
                              batch_stats=jtree["batch_stats"])
    jstep = j_train_cl.make_train_step_cl(jb, consistency_weight=0.1, score_thresh=0.0)
    arrays = j_train_cl.select_cl_arrays(cl_batch)
    state, jtb = jstep.lower(state, arrays).compile(compiler_options=XLA_O0)(state, arrays)
    jfinal = state_dict_from_flax({"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats)}, pb.module)

    pstate, _ = train_utils.create_train_state(pb, model["pcfg"].OPTIMIZATION, TOTAL_STEPS)
    pstep = train_cl.make_train_step_cl(pb, consistency_weight=0.1, score_thresh=0.0)
    pstate, ptb = pstep(pstate, cl_batch)
    grads = {n: p.grad.clone() for n, p in pb.module.named_parameters()}
    final = {k: v.clone() for k, v in pb.module.state_dict().items()}
    pb.module.load_state_dict(init)  # the module fixture's weights, for later tests

    assert set(ptb) == set(jtb)
    for k in jtb:
        assert abs(float(ptb[k]) - float(jtb[k])) <= 1e-4 * abs(float(jtb[k])), \
            (k, float(ptb[k]), float(jtb[k]))
    assert float(ptb["consistency_center"]) > 0
    bad, _ = update_mismatches(final, jfinal, init, grads, pstate.lr_fn(0))
    assert bad == [], bad[:5]
    for name, want in jfinal.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(final[name].numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
            assert not torch.equal(final[name], init[name]), name
