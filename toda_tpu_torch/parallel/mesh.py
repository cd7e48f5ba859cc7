"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``toda_tpu/parallel/mesh.py`` (``init_distributed``,
``init_dist_slurm``, ``get_dist_info``, ``shard_batch``, ``replicate``
:19-101). JAX runs one jitted step over the global batch sharded on a
device mesh, so its BatchNorm statistics and its loss normalisers are the
global batch's and the gradient is that of one loss. Here each process runs
its own share of the global batch, and the same function is kept by three
pieces:

  * every BatchNorm takes the statistics of the global batch: the sums it
    normalises by are all-reduced with
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces the cotangent, so the gradient through the statistics
    reaches every rank's inputs (``global_moments``; ``MaskedBatchNormT``
    calls it, ``convert_global_batchnorm`` swaps each ``nn.BatchNorm2d``
    for one that does);
  * the losses divide by global counts (``global_count``), so each rank's
    loss is its share of the global loss and the shares sum to it;
  * ``allreduce_grads`` sums the gradients of those shares across ranks
    (JAX's gradient of the one global loss), in flat buckets.

At world size 1 none of this runs: the same modules, the same numbers.
The process group is NCCL when the processes drive CUDA devices, gloo on
the CPU.
"""

import os

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 << 20  # gradients are all-reduced in flat buckets of this size


def get_dist_info():
    """(rank, world_size) of this process; (0, 1) when no group is set up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def get_world_size():
    return get_dist_info()[1]


def init_distributed(init_method=None, world_size=None, rank=None, device="cuda"):
    """Join the process group (``init_dist_pytorch`` of the reference):
    NCCL when ``device`` is CUDA, gloo on the CPU. World size 1 (or None)
    initialises nothing. On CUDA each process takes the card of its local
    rank (``LOCAL_RANK``, else its rank modulo the cards). Returns (rank,
    world)."""
    if world_size is None or world_size <= 1 or dist.is_initialized():
        return get_dist_info()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world_size, rank=rank)
    return get_dist_info()


def init_dist_slurm(port=29500, device="cuda"):
    """The process group from the SLURM environment (``init_dist_slurm`` of
    the reference): SLURM_PROCID, SLURM_NTASKS and the first host of
    SLURM_NODELIST as the address. Returns (rank, world)."""
    import subprocess

    if "SLURM_PROCID" not in os.environ:
        return get_dist_info()
    rank, world = int(os.environ["SLURM_PROCID"]), int(os.environ["SLURM_NTASKS"])
    if world <= 1:
        return get_dist_info()
    node_list = os.environ["SLURM_NODELIST"]
    addr = subprocess.getoutput(f"scontrol show hostname {node_list} | head -n1").strip()
    port = int(os.environ.get("MASTER_PORT", port))
    os.environ.setdefault("LOCAL_RANK", os.environ.get("SLURM_LOCALID", str(rank)))
    return init_distributed(f"tcp://{addr}:{port}", world, rank, device)


def shard_batch(batch, rank=None, world=None):
    """This rank's share of a global batch: rows rank, rank + world, ...
    of every array with a leading batch axis (the rank-strided loader
    already hands each rank its share; this cuts a global batch the same
    way). World size 1 returns the batch."""
    r, w = get_dist_info()
    rank, world = (r if rank is None else rank), (w if world is None else world)
    if world == 1:
        return batch
    return {k: v[rank::world] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


@torch.no_grad()
def replicate(module):
    """Rank 0's parameters and buffers to every rank (JAX's replicated
    state). World size 1 does nothing. Returns the module."""
    if get_world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def global_count(x):
    """The sum over ranks of a count or normaliser (no gradient), as a
    tensor; ``x`` itself at world size 1."""
    if get_world_size() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def global_moments(t):
    """The sum over ranks of a tensor of batch sums, differentiable: the
    backward all-reduces the cotangent, so each rank's inputs get the
    gradient of every rank's loss share through the global statistics."""
    if get_world_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def sum_scalars(tb):
    """{name: scalar tensor} summed over ranks in one all-reduce (the
    global loss terms from each rank's shares)."""
    if get_world_size() == 1 or not tb:
        return tb
    keys = list(tb)
    flat = torch.stack([tb[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


@torch.no_grad()
def allreduce_grads(params):
    """Sum each parameter's gradient over ranks, in place: flat buckets of
    one dtype up to ``BUCKET_BYTES``, one all-reduce each. A missing
    gradient counts as zeros (and is made so)."""
    if get_world_size() == 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket, size = [], 0
    for p in list(params) + [None]:
        if bucket and (p is None or p.grad.dtype != bucket[0].dtype
                       or size + p.grad.numel() * p.grad.element_size() > BUCKET_BYTES):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
            for g, v in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(v.view_as(g))
            bucket, size = [], 0
        if p is not None:
            bucket.append(p.grad)
            size += p.grad.numel() * p.grad.element_size()


def data_parallel(module):
    """A module ready for a data-parallel run: rank 0's weights on every
    rank and global-batch BatchNorm statistics (``replicate``,
    ``convert_global_batchnorm``). Nothing happens at world size 1."""
    return convert_global_batchnorm(replicate(module))


def convert_global_batchnorm(module):
    """At world size > 1, make every BatchNorm of ``module`` take the
    global batch's statistics: each ``nn.BatchNorm2d`` is swapped for a
    ``GlobalBatchNorm2d`` holding the same parameter and buffer tensors
    (an optimizer over them keeps working). At world size 1 the module is
    left as it is. Returns the module."""
    if get_world_size() == 1:
        return module
    from ..models.backbones_2d.base_bev_backbone import GlobalBatchNorm2d

    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is torch.nn.BatchNorm2d:
                parent._modules[name] = GlobalBatchNorm2d.from_batchnorm(child)
    return module
