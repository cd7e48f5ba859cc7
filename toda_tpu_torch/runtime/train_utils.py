"""The training step: voxelize + forward + loss + backward + clip + AdamW +
BatchNorm running statistics, on the device.

Counterpart of ``toda_tpu/runtime/train_utils.py`` (``select_batch_arrays``,
``create_train_state``, ``make_train_step`` :31-83). JAX's step is one jitted
pure function of the state; here one call runs the same work eagerly and
updates the module's parameters, BatchNorm buffers and the optimizer state
in place. The epoch loop (``train_model``) and checkpoints come with a
later slice.
"""

from .optimization import build_optimizer

ARRAY_KEYS = ("points", "points_mask", "gt_boxes")


def select_batch_arrays(batch):
    """Keep only the static-shape array fields the step consumes."""
    return {k: v for k, v in batch.items() if k in ARRAY_KEYS}


def create_train_state(bundle, opt_cfg, total_steps):
    """(state, LR schedule). The state is the optimizer over the bundle's
    parameters: it holds the Adam moments and the step count (``.count``);
    the parameters and BatchNorm statistics live in the bundle's module."""
    return build_optimizer(opt_cfg, total_steps, bundle.module.named_parameters())


def make_train_step(bundle):
    """train_step(state, batch) -> (state, tb): one optimizer step on a batch
    (numpy arrays or tensors; see ``select_batch_arrays``). tb holds the
    loss terms as device tensors; the step itself never waits for the
    device."""

    def train_step(state, batch):
        batch = bundle.to_device(select_batch_arrays(batch))
        for p in state.params:
            p.grad = None
        total, tb = bundle.loss(batch)
        total.backward()
        state.step()
        tb = {k: v.detach() for k, v in tb.items()}
        tb["loss"] = total.detach()
        return state, tb

    return train_step
