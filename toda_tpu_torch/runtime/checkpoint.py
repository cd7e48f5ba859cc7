"""Checkpoint save, restore and resume.

Counterpart of ``toda_tpu/runtime/checkpoint.py`` (``save_checkpoint`` with
FIFO pruning, ``load_checkpoint``, ``load_params_only``,
``latest_checkpoint`` :20-88) in the port's own format: one
``torch.save`` file ``checkpoint_epoch_<epoch>.pth`` holding the module's
state dict (parameters and BatchNorm statistics), the optimizer's moments and
step count, and the epoch. JAX's training state is one pytree; the port's
lives in two places, the bundle's module and the optimizer, so both are
passed. In a data-parallel run the save is collective: every rank calls it,
rank 0 writes (the ranks hold the same state) and all wait for the file.
"""

from pathlib import Path

import torch

from ..utils import commu_utils


def _ckpt_path(ckpt_dir, epoch):
    return Path(ckpt_dir) / f"checkpoint_epoch_{epoch}.pth"


def scan_dir_for_ckpts(ckpt_dir):
    """The checkpoints in ``ckpt_dir``, sorted by epoch."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []

    def epoch_of(p):
        try:
            return int(p.name.split("_")[-1].split(".")[0])
        except ValueError:
            return -1

    return sorted(ckpt_dir.glob("checkpoint_epoch_*.pth"), key=epoch_of)


def save_checkpoint(ckpt_dir, bundle, state, epoch, max_keep=30):
    """Write ``checkpoint_epoch_<epoch>.pth`` after removing the oldest
    checkpoints beyond ``max_keep - 1``; returns its path. Collective in a
    data-parallel run (rank 0 writes, every rank waits for it)."""
    ckpt_dir = Path(ckpt_dir)
    path = _ckpt_path(ckpt_dir, epoch)
    if commu_utils.get_rank() == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        existing = scan_dir_for_ckpts(ckpt_dir)
        for stale in existing[: max(0, len(existing) - max_keep + 1)]:
            stale.unlink()
        torch.save({"model": bundle.module.state_dict(), "optimizer": state.state_dict(),
                    "epoch": int(epoch)}, path)
    commu_utils.synchronize()
    return path


def load_checkpoint(path, bundle, state=None):
    """Restore a training checkpoint into the bundle's module and, when
    given, the optimizer (resume). Returns the checkpoint's epoch."""
    payload = torch.load(path, map_location=bundle.device, weights_only=True)
    bundle.module.load_state_dict(payload["model"], strict=True)
    if state is not None:
        state.load_state_dict(payload["optimizer"])
    return payload["epoch"]


def load_weights(path, device="cpu"):
    """A checkpoint's module state dict (parameters and BatchNorm
    statistics) on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)["model"]


def load_params_only(path, bundle):
    """Weights-only transfer (the next TODA stage's start): parameters and
    BatchNorm statistics; the optimizer starts afresh."""
    load_checkpoint(path, bundle)


def latest_checkpoint(ckpt_dir):
    ckpts = scan_dir_for_ckpts(ckpt_dir)
    return ckpts[-1] if ckpts else None
