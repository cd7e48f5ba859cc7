"""The training step (voxelize + forward + loss + backward + clip + AdamW +
BatchNorm running statistics, on the device) and the epoch loop.

Counterpart of ``toda_tpu/runtime/train_utils.py`` (``select_batch_arrays``,
``create_train_state``, ``make_train_step`` :31-83, ``train_model``
:86-180). JAX's step is one jitted pure function of the state; here one call
runs the same work eagerly and updates the module's parameters, BatchNorm
buffers and the optimizer state in place. ``train_model`` runs in one
process: the device mesh, the cross-rank checksum, the timing log and the
save-interval and keep-count settings come with the distributed runtime and
the CLIs.
"""

from . import checkpoint as ckpt_lib
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


def train_model(bundle, state, train_loader, start_epoch, total_epochs, ckpt_save_dir,
                hooks=()):
    """The epoch loop (``train_model`` :86-180): each epoch sets the loader's
    epoch, runs ``make_train_step`` over it and saves a checkpoint
    (``checkpoint.save_checkpoint``). Before each batch is drawn the
    dataset's ``train_percent`` (the stage-1 mixers' curriculum) is set to
    the fraction of the run's steps taken, as in JAX. Each hook is called as
    ``hook(state, batch, tb, step)`` after a step. Returns the state."""
    train_step = make_train_step(bundle)
    accumulated_iter = state.count
    run_its = max(len(train_loader) * total_epochs, 1)
    for cur_epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(cur_epoch)
        train_loader.dataset.train_percent = accumulated_iter / run_its
        for batch in train_loader:
            train_loader.dataset.train_percent = (accumulated_iter + 1) / run_its
            state, tb = train_step(state, batch)
            for hook in hooks:
                hook(state, batch, tb, accumulated_iter)
            accumulated_iter += 1
        ckpt_lib.save_checkpoint(ckpt_save_dir, bundle, state, epoch=cur_epoch + 1)
    return state
