"""The training step (voxelize + forward + loss + backward + clip + AdamW +
BatchNorm running statistics, on the device) and the epoch loop.

Counterpart of ``toda_tpu/runtime/train_utils.py`` (``select_batch_arrays``,
``create_train_state``, ``make_train_step`` :31-83, ``train_model``
:86-180). JAX's step is one jitted pure function of the state; here one call
runs the same work eagerly and updates the module's parameters, BatchNorm
buffers and the optimizer state in place. In a data-parallel run each rank
steps on its share of the global batch: the BatchNorm statistics and the
loss normalisers are the global batch's (``parallel.mesh``), the gradients
of the ranks' loss shares are summed across ranks before the clip and the
update, so every rank takes JAX's step on the global batch.
"""

import os
import time

from ..parallel.mesh import allreduce_grads, data_parallel, sum_scalars
from ..utils import commu_utils
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
    loss terms as device tensors, the global batch's in a data-parallel run;
    at world size 1 the step itself never waits for the device."""

    def train_step(state, batch):
        batch = bundle.to_device(select_batch_arrays(batch))
        for p in state.params:
            p.grad = None
        total, tb = bundle.loss(batch)
        total.backward()
        allreduce_grads(state.params)
        state.step()
        tb = {k: v.detach() for k, v in tb.items()}
        tb["loss"] = total.detach()
        return state, sum_scalars(tb)

    return train_step


class AverageMeter:
    """Running average of a host timing (the reference's meter)."""

    def __init__(self):
        self.val = self.sum = self.avg = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def train_model(bundle, state, train_loader, start_epoch, total_epochs, ckpt_save_dir,
                schedule=None, logger=None, ckpt_save_interval=1, max_ckpt_save_num=30,
                tb_log=None, hooks=()):
    """The epoch loop (``train_model`` :86-180). At world size > 1 it first
    replicates rank 0's weights and turns on global-batch BatchNorm
    statistics (``parallel.mesh``). Each epoch sets the loader's epoch and
    runs ``make_train_step``'s step over it; before each
    batch is drawn the dataset's ``train_percent`` (the stage-1 mixers'
    curriculum) is set to the fraction of the run's steps taken, as in JAX.
    Each hook is called as ``hook(state, batch, tb, step)`` after a step.
    ``TODA_DEBUG_CHECKSUM=N`` asserts every N steps that the ranks' parameters
    agree. ``logger`` (every rank's, or none) gets the loss, the LR and the
    data and batch times averaged over the ranks four times an epoch;
    ``tb_log`` (rank 0's) every step's loss terms, LR and timings. A
    checkpoint is saved (collectively) every ``ckpt_save_interval`` epochs
    and after the last, keeping ``max_ckpt_save_num``. Returns the state."""
    data_parallel(bundle.module)
    train_step = make_train_step(bundle)
    checksum_every = int(os.environ.get("TODA_DEBUG_CHECKSUM", "0"))
    accumulated_iter = state.count
    total_its = len(train_loader)
    run_its = max(total_its * total_epochs, 1)
    for cur_epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(cur_epoch)
        data_meter, batch_meter = AverageMeter(), AverageMeter()
        end = time.time()
        train_loader.dataset.train_percent = accumulated_iter / run_its
        for it, batch in enumerate(train_loader):
            data_meter.update(time.time() - end)
            train_loader.dataset.train_percent = (accumulated_iter + 1) / run_its
            state, tb = train_step(state, batch)
            for hook in hooks:
                hook(state, batch, tb, accumulated_iter)
            if checksum_every and accumulated_iter % checksum_every == 0:
                commu_utils.assert_params_in_sync(state.params, tag=f"iter {accumulated_iter}")
            accumulated_iter += 1
            batch_meter.update(time.time() - end)
            end = time.time()
            if logger is not None and it % max(total_its // 4, 1) == 0:
                lr = schedule(accumulated_iter) if schedule else 0.0
                data_avg = commu_utils.average_reduce_value(data_meter.avg)
                batch_avg = commu_utils.average_reduce_value(batch_meter.avg)
                logger.info("epoch %d it %d/%d loss %.4f lr %.2e data %.3fs batch %.3fs",
                            cur_epoch, it, total_its, float(tb["loss"]), lr, data_avg,
                            batch_avg)
            if tb_log is not None:
                for k, v in tb.items():
                    tb_log.add_scalar(f"train/{k}", float(v), accumulated_iter)
                if schedule is not None:
                    tb_log.add_scalar("meta_data/learning_rate", schedule(accumulated_iter),
                                      accumulated_iter)
                tb_log.add_scalar("meta_data/data_time", data_meter.val, accumulated_iter)
                tb_log.add_scalar("meta_data/batch_time", batch_meter.val, accumulated_iter)
        if cur_epoch % ckpt_save_interval == 0 or cur_epoch == total_epochs - 1:
            ckpt_lib.save_checkpoint(ckpt_save_dir, bundle, state, epoch=cur_epoch + 1,
                                     max_keep=max_ckpt_save_num)
    return state
