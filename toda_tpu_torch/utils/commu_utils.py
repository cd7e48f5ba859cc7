"""Cross-process communication helpers on ``torch.distributed``.

Counterpart of ``toda_tpu/utils/commu_utils.py`` (:20-136): pickled-object
``all_gather``, the rank-interleaved result merge, scalar and dict
reductions, ``concat_all_gather`` and the debug parameter checksum. Every
function is an identity (or a no-op) at world size 1.
"""

import numpy as np
import torch.distributed as dist

from ..parallel.mesh import get_dist_info, get_world_size  # noqa: F401 (part of the API)


def get_rank():
    return get_dist_info()[0]


def synchronize():
    """Barrier across processes."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data):
    """Every process's picklable ``data`` -> list ordered by rank."""
    world = get_world_size()
    if world == 1:
        return [data]
    out = [None] * world
    dist.all_gather_object(out, data)
    return out


def merge_results_dist(part_results, total_size):
    """Per-process partial result lists -> one list of ``total_size``,
    interleaved by rank (the rank-strided loader gave rank r the frames r,
    r + world, ...), the longer ranks' tails appended in rank order."""
    parts = all_gather(part_results)
    merged = []
    for tup in zip(*parts):
        merged.extend(tup)
    for i in range(min(len(p) for p in parts), max(len(p) for p in parts)):
        merged.extend(p[i] for p in parts if i < len(p))
    return merged[:total_size]


def average_reduce_value(value):
    """Mean of a Python scalar across processes."""
    if get_world_size() == 1:
        return value
    return float(np.mean(all_gather(float(value))))


def reduce_dict(input_dict, average=True):
    """A {str: scalar} dict reduced across processes (mean or sum)."""
    if get_world_size() == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    arr = np.asarray(all_gather([float(input_dict[k]) for k in keys]))  # (world, K)
    red = arr.mean(axis=0) if average else arr.sum(axis=0)
    return dict(zip(keys, red.tolist()))


def concat_all_gather(array):
    """A numpy array concatenated across processes along axis 0."""
    if get_world_size() == 1:
        return np.asarray(array)
    return np.concatenate(all_gather(np.asarray(array)), axis=0)


def params_checksum(tensors):
    """f64 sum of the absolute values of ``tensors`` (parameters, or a
    module's state dict values)."""
    return float(sum(t.detach().double().abs().sum().item() for t in tensors))


def assert_params_in_sync(tensors, tag="params", rtol=1e-9):
    """Debug check that every process holds the same parameters: each
    checksums its own and all must agree (a desynchronised optimizer step
    or a wrong gradient reduction fails it). Enabled in ``train_model`` by
    ``TODA_DEBUG_CHECKSUM=N`` (every N steps). Returns this process's sum."""
    local = params_checksum(tensors)
    sums = all_gather(local)
    ref = sums[0]
    if any(abs(s - ref) > rtol * max(abs(ref), 1.0) for s in sums):
        raise AssertionError(f"cross-process parameter checksums differ at {tag}: {sums}")
    return local

