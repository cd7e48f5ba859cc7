"""Carry weights from the JAX package's variable tree into the port,
initialise a model as the JAX package does, and make random weights from a
seed.

``state_dict_from_flax`` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays (the flax tree with ``np.asarray`` leaves) and
the port module they are for, and returns a ``state_dict`` that
``module.load_state_dict(..., strict=True)`` takes. A flax kernel converts
by the kind of port module it belongs to, never by its shape alone (a dense
3D conv kernel and a sparse 3x3x3 kernel are both 5-D ``kernel``s):
  * ``nn.Linear`` (flax ``Dense``): (in, out) -> weight (out, in);
  * ``nn.Conv2d`` / ``nn.Conv3d``: (k..., cin, cout) -> weight (cout, cin, k...);
  * ``nn.ConvTranspose2d`` (flax ConvTranspose with transpose_kernel=False):
    (kh, kw, cin, cout) -> weight (cin, cout, kh, kw), flipped in both
    spatial dims (flax gives out[s*i + a] = x[i] * W[s-1-a], torch x[i] * W[a]);
  * any other module (the sparse convs) keeps its flax parameters as they
    are: ``kernel`` (3, 3, 3, C, Cout), ``proj_kernel`` (cin, cout);
  * BatchNorm scale/bias -> weight/bias, mean/var -> running_mean/running_var,
    plus a zero num_batches_tracked (flax momentum 0.99 is torch 0.01; the
    epsilon, 1e-3, is set on the modules).
"""

import math

import numpy as np
import torch
from torch import nn

_CONVS = (nn.Conv2d, nn.Conv3d)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _param(owner, name, arr):
    """(port name, value) of flax parameter ``name`` of port module ``owner``."""
    if name == "kernel" and isinstance(owner, nn.Linear):
        return "weight", arr.T
    if name == "kernel" and isinstance(owner, nn.ConvTranspose2d):
        return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if name == "kernel" and isinstance(owner, _CONVS):
        return "weight", np.moveaxis(arr, (-1, -2), (0, 1))
    if name in ("kernel", "proj_kernel"):
        return name, arr
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise KeyError(f"unknown flax parameter {name} of {type(owner).__name__}")


def _tensor(arr):
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def state_dict_from_flax(variables, module):
    """Port state_dict for ``module`` of a flax ``{"params", "batch_stats"}``
    tree (either part may be absent: a gradient tree has only params)."""
    sd = {}
    for path, arr in _leaves(variables.get("params", {})):
        name, val = _param(module.get_submodule(".".join(path[:-1])), path[-1], arr)
        sd[".".join(path[:-1] + (name,))] = _tensor(val)
    for path, arr in _leaves(variables.get("batch_stats", {})):
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        prefix = ".".join(path[:-1])
        sd[f"{prefix}.{name}"] = _tensor(arr)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _states(module):
    """(name, tensor, leaf name, owning module) of every state_dict entry."""
    for name, t in module.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        yield name, t, leaf, module.get_submodule(owner)


def randomize_(module, seed):
    """Fill every parameter and BatchNorm buffer of ``module`` from a seeded
    generator: kernels and conv / linear weights He-normal, BatchNorm near
    identity with some spread, biases small. Returns the module."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    with torch.no_grad():
        for name, t, leaf, owner in _states(module):
            if leaf == "num_batches_tracked":
                continue
            if leaf in ("kernel", "proj_kernel"):  # (..., cin, cout)
                val = normal(t.shape, (2.0 / (t.numel() // t.shape[-1])) ** 0.5)
            elif leaf == "weight" and isinstance(owner, nn.ConvTranspose2d):
                val = normal(t.shape, (2.0 / t.shape[0]) ** 0.5)
            elif leaf == "weight" and isinstance(owner, (*_CONVS, nn.Linear)):
                val = normal(t.shape, (2.0 / (t.numel() // t.shape[0])) ** 0.5)
            elif leaf == "weight":
                val = uniform(t.shape, 0.8, 1.2)
            elif leaf in ("bias", "running_mean"):
                val = normal(t.shape, 0.1)
            elif leaf == "running_var":
                val = uniform(t.shape, 0.5, 1.5)
            else:
                raise KeyError(f"randomize_: unexpected state {name}")
            t.copy_(val.to(t.dtype))
    return module


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _truncated_normal(shape, std, gen):
    """jax.random.truncated_normal(-2, 2) * std / _TRUNC_STD by inverse CDF,
    as flax's ``truncated_normal`` variance scaling draws it."""
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    return (z * (std / _TRUNC_STD)).float()


def init_like_flax_(module, seed):
    """Initialise every parameter and BatchNorm buffer of ``module`` with the
    distributions the JAX package's flax modules use, from a seeded
    generator: sparse 3x3x3 kernels He-normal (variance_scaling(2, fan_in,
    normal)); conv, transposed-conv, linear and ``proj_kernel`` weights LeCun
    truncated normal, unless the owning module names another flax init in
    ``flax_init`` (``"xavier_normal"`` or ``("normal", std)``); biases zero,
    or the owner's ``flax_bias_init``; BatchNorm weight 1, bias 0, running
    mean 0, running variance 1. The numbers differ from flax's (another
    generator); the distributions are the same. Returns the module."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t, leaf, owner in _states(module):
            if leaf == "num_batches_tracked":
                continue
            if leaf == "kernel":  # (3, 3, 3, cin, cout)
                val = torch.randn(t.shape, generator=gen) * (2.0 / (27 * t.shape[3])) ** 0.5
            elif leaf == "proj_kernel":  # (cin, cout)
                val = _truncated_normal(t.shape, t.shape[0] ** -0.5, gen)
            elif leaf == "weight" and isinstance(owner, (*_CONVS, nn.Linear,
                                                         nn.ConvTranspose2d)):
                # flax's fan_in is cin * prod(kernel); fan_out cout * prod(kernel)
                cin = t.shape[0] if isinstance(owner, nn.ConvTranspose2d) else t.shape[1]
                fan_in = cin * t[0, 0].numel()
                init = getattr(owner, "flax_init", None)
                if init == "xavier_normal":
                    val = _truncated_normal(t.shape, (2.0 / (fan_in + t.numel() // fan_in)) ** 0.5,
                                            gen)
                elif init is not None:
                    val = torch.randn(t.shape, generator=gen) * init[1]
                else:
                    val = _truncated_normal(t.shape, fan_in ** -0.5, gen)
            elif leaf == "weight" or leaf == "running_var":
                val = torch.ones(t.shape)
            elif leaf == "bias":
                val = torch.full(t.shape, getattr(owner, "flax_bias_init", 0.0))
            elif leaf == "running_mean":
                val = torch.zeros(t.shape)
            else:
                raise KeyError(f"init_like_flax_: unexpected state {name}")
            t.copy_(val.to(t.dtype))
    return module
