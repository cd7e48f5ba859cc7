"""The CenterPoint-Res training step: the PyTorch port against the JAX package.

The tiny CenterPoint-Res of ``test_torch_model.py`` in f32 starts from JAX's
own initialisation (``create_train_state``'s), carried into the port by
``state_dict_from_flax``. JAX's programs are compiled at -O0
(``test_torch_model.XLA_O0``). Both train on the same augmented training batch
(the JAX loader's) for three steps: the port's ``make_train_step``, and
JAX's composed as its ``make_train_step`` composes them (``bundle.loss``'s
value and gradient, then ``TrainState.apply_gradients``; this detector draws
no random numbers in a step), so one compile gives JAX's step-1 gradients
and its three steps. The OneCycle LR and b1, AdamW with weight decay, the
global-norm clip and the BatchNorm running statistics are all on the path. The updates are held by
``chip_smoke.update_mismatches``, the check the card's run applies to cuda
against cpu; planted optimizer faults show that it fails them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import update_mismatches
from test_torch_model import CFG, jit_o0, tiny

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.models import build_network as j_build_network
from toda_tpu.runtime import optimization as j_optimization
from toda_tpu.runtime import train_utils as j_train_utils
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.runtime import optimization, train_utils
from toda_tpu_torch.weights import state_dict_from_flax

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

STEPS = 3
TOTAL_STEPS = 10  # the schedules' length: the 3 steps climb the OneCycle warm-up


@functools.lru_cache(maxsize=1)
def _port_module():
    """A port module of the tiny model, the target of the weight carrier
    (built once: the carrier only reads its structure)."""
    pcfg = tiny(cfg_from_yaml_file(CFG, EDict()), False)
    return build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                         build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES), device="cpu").module


def _state_dict(params, batch_stats):
    return state_dict_from_flax({"params": jax.device_get(params),
                                 "batch_stats": jax.device_get(batch_stats)}, _port_module())


def _port_steps(init, batch):
    """STEPS port ``make_train_step`` steps from ``init`` on ``batch``: the
    losses, the first step's gradients, the final state dict, the sum of
    the steps' LRs and the bundle."""
    pcfg = tiny(cfg_from_yaml_file(CFG, EDict()), False)
    pb = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                       build_dataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, training=True),
                       device="cpu")
    pb.module.load_state_dict(init, strict=True)
    pstate, _ = train_utils.create_train_state(pb, pcfg.OPTIMIZATION, TOTAL_STEPS)
    pstep = train_utils.make_train_step(pb)
    losses, grads = [], None
    for _ in range(STEPS):
        pstate, tb = pstep(pstate, batch)
        losses.append({k: float(v) for k, v in tb.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in pb.module.named_parameters()}
    return dict(losses=losses, grads=grads, final=pb.module.state_dict(), bundle=pb,
                lr_sum=sum(pstate.lr_fn(s) for s in range(STEPS)))


@pytest.fixture(scope="module")
def runs():
    np.random.seed(0)
    jcfg = tiny(j_cfg_from_yaml_file(CFG, JEDict()), False)
    jds, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                         training=True)
    batch = next(iter(jloader))
    arrays = {k: jnp.asarray(v) for k, v in j_train_utils.select_batch_arrays(batch).items()}
    jb = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=jds)
    # create_train_state (JAX train_utils.py:71-83) with DetectorBundle.init's
    # keys and training-mode init
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    variables = jit_o0(lambda b: jb.module.init(
        {"params": k1, "sampling": k2, "dropout": k3}, b, training=True))(arrays)
    tx, _ = j_optimization.build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
    state = j_train_utils.TrainState.create(apply_fn=jb.module.apply,
                                            params=variables["params"], tx=tx,
                                            batch_stats=variables["batch_stats"])
    init = _state_dict(state.params, state.batch_stats)
    jtargets = jax.device_get(jb._center_head_helper().assign_targets(arrays["gt_boxes"]))
    step_batch = dict(arrays, batch_size=2)

    @jit_o0
    def value_and_grad(p, s):
        def loss_fn(p):
            total, (tb, new_state) = jb.loss({"params": p, "batch_stats": s}, step_batch)
            return total, (tb, new_state)

        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    @jax.jit
    def apply_gradients(state, grads, new_stats):
        return state.apply_gradients(grads=grads).replace(batch_stats=new_stats)

    jlosses, jgrads = [], None
    for _ in range(STEPS):
        (loss, (tb, new_state)), grads = value_and_grad(state.params, state.batch_stats)
        jgrads = grads if jgrads is None else jgrads
        state = apply_gradients(state, grads, new_state["batch_stats"])
        jlosses.append({**{k: float(v) for k, v in tb.items()}, "loss": float(loss)})

    port = _port_steps(init, batch)
    ptargets = port["bundle"].module.dense_head.assign_targets(
        torch.as_tensor(np.asarray(batch["gt_boxes"])))
    return dict(
        jgrads=state_dict_from_flax({"params": jax.device_get(jgrads)}, _port_module()),
        pgrads=port["grads"],
        jlosses=jlosses, plosses=port["losses"], jtargets=jtargets, ptargets=ptargets,
        jfinal=_state_dict(state.params, state.batch_stats), pfinal=port["final"],
        init=init, batch=batch, lr_sum=port["lr_sum"])


def test_targets_equal_jax(runs):
    """Heatmaps, indices, masks and box targets of the same gt boxes."""
    for j, p in zip(runs["jtargets"], runs["ptargets"]):
        assert p["mask"].any()
        np.testing.assert_array_equal(p["mask"].numpy(), np.asarray(j["mask"]))
        np.testing.assert_array_equal(p["ind"].numpy(), np.asarray(j["ind"]))
        for k in ("heatmap", "box_targets"):
            np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_step1_gradients_equal_jax(runs):
    """Every parameter's gradient of the first step agrees to 1e-3 of that
    parameter's largest |gradient| (f32; sums in another order)."""
    jg, pg = runs["jgrads"], runs["pgrads"]
    assert set(jg) == set(pg)
    for name, want in jg.items():
        scale = max(float(want.abs().max()), 1e-12)
        err = float((pg[name] - want).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


def test_three_step_losses_equal_jax(runs):
    """loss, rpn_loss, hm_loss_head_0 and loc_loss_head_0 of each of the
    three steps agree to 1e-3 relative, and the loss goes down."""
    for j, p in zip(runs["jlosses"], runs["plosses"]):
        assert set(j) == set(p) == {"loss", "rpn_loss", "hm_loss_head_0", "loc_loss_head_0"}
        for k in j:
            assert abs(p[k] - j[k]) <= 1e-3 * abs(j[k]), (k, p[k], j[k])
    assert runs["plosses"][-1]["loss"] < runs["plosses"][0]["loss"]


def test_params_and_running_stats_after_three_steps_equal_jax(runs):
    """After three steps each parameter's update (final - init) agrees with
    JAX's to 1e-3 of the sum of the steps' LRs on every element whose
    step-1 JAX gradient is above 1e-3 of its leaf's largest (the rest, where
    Adam's sign-like step may go either way, to 2x that sum); see
    ``update_mismatches``. BatchNorm running statistics agree to 1e-4, and
    every parameter moved."""
    jf, pf, init = runs["jfinal"], runs["pfinal"], runs["init"]
    assert update_mismatches(pf, jf, init, runs["jgrads"], runs["lr_sum"])[0] == []
    for name, want in jf.items():
        got = pf[name].float()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        elif not name.endswith("num_batches_tracked"):
            assert not torch.equal(got, init[name]), name


def _decay_bn_scale(name, param):
    return name.rsplit(".", 1)[-1] in ("kernel", "proj_kernel", "weight")


FAULTS = {
    # weight decay on the BatchNorm scales too (flax's mask leaves them out)
    "bn_scale_decayed": (optimization, "decays", _decay_bn_scale),
    # Adam's b1 held at MOMS[0] instead of following the OneCycle companion
    "fixed_b1": (optimization, "build_b1_schedule", lambda cfg, total: lambda step: 0.95),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_update_check_fails_planted_optimizer_fault(runs, fault, monkeypatch):
    """The update check of the test above rejects a port optimizer with a
    planted fault: a decayed BatchNorm scale is flagged on exactly the
    BatchNorm scales, a fixed b1 on most leaves."""
    monkeypatch.setattr(*FAULTS[fault])
    port = _port_steps(runs["init"], runs["batch"])
    bad = {name for name, _, _ in update_mismatches(port["final"], runs["jfinal"], runs["init"],
                                                   runs["jgrads"], runs["lr_sum"])[0]}
    if fault == "bn_scale_decayed":
        scales = {n for n, p in port["bundle"].module.named_parameters()
                  if n.endswith(".weight") and p.dim() == 1}
        assert scales and bad == scales
    else:
        assert len(bad) > len(runs["jgrads"]) // 2, sorted(bad)
