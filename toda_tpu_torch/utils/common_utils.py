"""Common host helpers and the port's device rule.

The numpy helpers, the logger, the seed setter and the /dev/shm staging of
a gt database (``shm_cache_file``, ``shm_cache_clear``) are the port's own
copies of the ones in ``toda_tpu/utils/common_utils.py`` that the data path
and the CLIs need; ``shm_cache_file`` names its copy by the source's path
and modification time, where JAX's uses the file name alone.
"""

import hashlib
import logging
import os
import random
import shutil
import time
from pathlib import Path

import numpy as np
import torch


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent; the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


def limit_period_torch(val, offset=0.5, period=np.pi):
    """``limit_period`` on tensors (``limit_period_jnp``)."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z_torch(points, angle):
    """z-rotation of tensors (``rotate_points_along_z_jnp``): points
    (..., N, 3 + C), angle (...,), counter-clockwise radians."""
    cosa, sina = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(cosa), torch.ones_like(cosa)
    rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones],
                      dim=-1).reshape(angle.shape + (3, 3))
    return torch.cat([points[..., :3] @ rot, points[..., 3:]], dim=-1)


def rotate_points_along_z(points, angle):
    """Rotate points around the z-axis (counter-clockwise, radians).
    points (B, N, 3 + C) with angle (B,), or (N, 3 + C) with a scalar."""
    points = np.asarray(points)
    single = points.ndim == 2
    if single:
        points = points[None]
        angle = np.asarray([angle], dtype=points.dtype)
    angle = np.asarray(angle, dtype=points.dtype)
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(cosa), np.ones_like(cosa)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    pts_rot = np.matmul(points[:, :, :3], rot)
    pts_rot = np.concatenate([pts_rot, points[:, :, 3:]], axis=-1)
    return pts_rot[0] if single else pts_rot


def mask_points_by_range(points, limit_range):
    return (
        (points[:, 0] >= limit_range[0])
        & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1])
        & (points[:, 1] <= limit_range[4])
    )


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def pad_to(arr, size, axis=0, value=0.0):
    """Pad ``arr`` along ``axis`` to ``size`` with ``value`` (truncating if longer)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    if n == size:
        return arr
    if n > size:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, size)
        return arr[tuple(sl)]
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, size - n)
    return np.pad(arr, pad_width, mode="constant", constant_values=value)


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """A logger to the console and ``log_file``; ranks other than 0 log
    errors only."""
    logger = logging.getLogger(str(log_file) if log_file else __name__)
    level = log_level if rank == 0 else logging.ERROR
    logger.setLevel(level)
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not logger.handlers:
        handlers = [logging.StreamHandler()]
        if log_file is not None:
            handlers.append(logging.FileHandler(log_file))
        for h in handlers:
            h.setLevel(level)
            h.setFormatter(formatter)
            logger.addHandler(h)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    """Seed Python's, numpy's and torch's generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


SHM_DIR = "/dev/shm/toda_tpu_torch"


def shm_cache_file(src_path, shm_dir=SHM_DIR, timeout_s=600.0):
    """Stage a file into /dev/shm once per host; every process gets the shm
    path (the gt database's ``SHM_CACHE``). The copy is named by the
    source's absolute path, modification time and size, so a rewritten
    source, or another checkout's file of the same name, gets a copy of its
    own and never reads a stale one. The leader is elected with an O_EXCL
    lock file and publishes through an atomic rename, so any mix of host
    processes shares one copy with no process group; the others poll until
    it appears. Falls back to the source path when /dev/shm is
    unavailable."""
    src_path = Path(src_path)
    shm_dir = Path(shm_dir)
    st = src_path.stat()
    key = hashlib.sha1(
        f"{src_path.resolve()}:{st.st_mtime_ns}:{st.st_size}".encode()).hexdigest()[:16]
    dst = shm_dir / f"{src_path.stem}-{key}{src_path.suffix}"
    if dst.exists():
        return dst
    try:
        shm_dir.mkdir(parents=True, exist_ok=True)
    except OSError:
        return src_path

    lock = dst.with_suffix(dst.suffix + ".lock")
    try:
        fd = os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        fd = None
    except OSError:
        return src_path

    if fd is not None:  # leader: copy to a temp name, then rename
        try:
            tmp = dst.with_suffix(dst.suffix + f".tmp{os.getpid()}")
            shutil.copyfile(str(src_path), str(tmp))
            os.replace(str(tmp), str(dst))
        finally:
            os.close(fd)
            lock.unlink(missing_ok=True)
        return dst

    deadline = time.monotonic() + timeout_s
    while not dst.exists():
        if not lock.exists() and not dst.exists():
            # the leader died before publishing: elect again
            return shm_cache_file(src_path, shm_dir=shm_dir, timeout_s=timeout_s)
        if time.monotonic() > deadline:
            return src_path  # read the original instead
        time.sleep(0.05)
    return dst


def shm_cache_clear(shm_dir=SHM_DIR):
    """Remove this host's staged copies."""
    shm_dir = Path(shm_dir)
    if shm_dir.exists():
        shutil.rmtree(shm_dir, ignore_errors=True)
