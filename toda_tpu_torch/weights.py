"""Carry weights from the JAX package's variable tree into the port, and
make random weights from a seed.

``state_dict_from_flax`` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays (the flax tree with ``np.asarray`` leaves) and
returns a ``state_dict`` that ``Detector3D.load_state_dict(..., strict=True)``
takes. Conversions:
  * 2D conv kernels (kh, kw, cin, cout) -> (cout, cin, kh, kw);
  * transposed-conv kernels (``*_deconv``, flax ConvTranspose with
    transpose_kernel=False) -> (cin, cout, kh, kw), flipped in both spatial
    dims (flax gives out[s*i + a] = x[i] * W[s-1-a], torch x[i] * W[a]);
  * sparse 3x3x3 kernels keep (3, 3, 3, C, Cout); ``proj_kernel`` keeps (cin, cout);
  * BatchNorm scale/bias -> weight/bias, mean/var -> running_mean/running_var,
    plus a zero num_batches_tracked (flax momentum 0.99 is torch 0.01; the
    epsilon, 1e-3, is set on the modules).
"""

import numpy as np
import torch


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _param(path, arr):
    name = path[-1]
    if name == "kernel" and arr.ndim == 4:
        if path[-2].endswith("_deconv"):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        return "weight", arr.transpose(3, 2, 0, 1)
    if name in ("kernel", "proj_kernel"):
        return name, arr
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise KeyError(f"unknown flax parameter {'/'.join(path)}")


def _tensor(arr):
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def state_dict_from_flax(variables):
    """Port state_dict of a flax ``{"params", "batch_stats"}`` tree."""
    sd = {}
    for path, arr in _leaves(variables["params"]):
        name, val = _param(path, arr)
        sd[".".join(path[:-1] + (name,))] = _tensor(val)
    for path, arr in _leaves(variables.get("batch_stats", {})):
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        prefix = ".".join(path[:-1])
        sd[f"{prefix}.{name}"] = _tensor(arr)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def randomize_(module, seed):
    """Fill every parameter and BatchNorm buffer of ``module`` from a seeded
    generator: kernels with He-normal scale, BatchNorm near identity with
    some spread, biases small. Returns the module."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked":
                continue
            if leaf in ("kernel", "proj_kernel"):  # (..., cin, cout)
                val = normal(t.shape, (2.0 / (t.numel() // t.shape[-1])) ** 0.5)
            elif leaf == "weight" and t.dim() == 4:  # conv / deconv
                fan_in = t.numel() // t.shape[0] if "deconv" not in name else t.shape[0]
                val = normal(t.shape, (2.0 / fan_in) ** 0.5)
            elif leaf == "weight":
                val = uniform(t.shape, 0.8, 1.2)
            elif leaf == "bias":
                val = normal(t.shape, 0.1)
            elif leaf == "running_mean":
                val = normal(t.shape, 0.1)
            elif leaf == "running_var":
                val = uniform(t.shape, 0.5, 1.5)
            else:
                raise KeyError(f"randomize_: unexpected state {name}")
            t.copy_(val.to(t.dtype))
    return module
