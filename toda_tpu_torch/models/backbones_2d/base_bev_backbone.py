"""Dense BEV backbone: strided conv stages + upsample-and-concat.

Counterpart of ``toda_tpu/models/backbones_2d/base_bev_backbone.py`` in NCHW.
Module names mirror the flax ones (``block{i}_down_conv`` ...). Two flax
conventions are reproduced explicitly:
  * ``padding="SAME"`` with stride 2 pads (0, 1) on an even map, not (1, 1):
    the input is padded as flax pads it, then convolved without padding;
  * flax ``ConvTranspose`` with kernel == stride gives out[s*i + a] =
    x[i] * W[s-1-a]; ``weights.state_dict_from_flax`` flips the kernel so that
    ``nn.ConvTranspose2d`` computes the same.
The blocks compute in the input's dtype (bf16 when the 3D backbone runs in
bf16, as in JAX); the output is f32. BatchNorm follows flax: in training, f32
batch statistics with the biased variance and running statistics updated
with momentum 0.99 (``bn_apply``); a ``GlobalBatchNorm2d`` (data-parallel
runs) takes them over the global batch.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count, global_moments


def same_pad(x, k, s):
    """Pad NCHW x as flax/XLA "SAME" does for a k x k kernel at stride s."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv_same(x, conv):
    """``conv`` (a padding-0 nn.Conv2d) applied with flax SAME padding, in
    x's dtype."""
    k, s = conv.kernel_size[0], conv.stride[0]
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(same_pad(x, k, s), w, b, stride=s)


FLAX_MOMENTUM = 0.99  # flax BatchNorm momentum: running = 0.99 * running + 0.01 * batch


def bn_apply(x, bn):
    """flax ``nn.BatchNorm`` on NCHW x with ``bn``'s parameters and buffers.

    Eval: the running statistics as one per-channel affine in x's dtype.
    Training: mean and the biased variance E[x^2] - mean^2 (floored at 0) of
    x in f32, ``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32 cast to
    x's dtype, and running = 0.99 * running + 0.01 * batch statistic (not
    ``F.batch_norm``'s unbiased running variance)."""
    if not bn.training:
        scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    xf = x.float()
    if isinstance(bn, GlobalBatchNorm2d):
        sums = global_moments(torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]))
        n = global_count(torch.tensor(float(xf.numel() // xf.shape[1]), device=x.device))
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    else:
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        m = FLAX_MOMENTUM
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def make_bn(c):
    return nn.BatchNorm2d(c, eps=1e-3, momentum=1 - FLAX_MOMENTUM)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """A ``make_bn`` BatchNorm of a data-parallel run: ``bn_apply`` takes
    its training statistics over the global batch (the sums all-reduced
    across ranks, differentiably), as JAX's one step over the sharded global
    batch does. ``parallel.convert_global_batchnorm`` swaps it in at world
    size > 1."""

    @classmethod
    def from_batchnorm(cls, bn):
        """A GlobalBatchNorm2d holding ``bn``'s parameter and buffer
        tensors themselves."""
        new = cls(bn.num_features, eps=bn.eps, momentum=bn.momentum, device=bn.weight.device)
        new.weight, new.bias = bn.weight, bn.bias
        new.running_mean, new.running_var = bn.running_mean, bn.running_var
        new.num_batches_tracked = bn.num_batches_tracked
        return new.train(bn.training)


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        layer_nums = list(model_cfg.get("LAYER_NUMS", []))
        layer_strides = list(model_cfg.get("LAYER_STRIDES", []))
        num_filters = list(model_cfg.get("NUM_FILTERS", []))
        upsample_strides = list(model_cfg.get("UPSAMPLE_STRIDES", []))
        num_upsample_filters = list(model_cfg.get("NUM_UPSAMPLE_FILTERS", []))
        if len(upsample_strides) != len(layer_nums) or any(s < 1 for s in upsample_strides):
            raise NotImplementedError(
                "the port's BaseBEVBackbone takes one upsample per block, with stride >= 1")
        self.layer_nums = layer_nums
        c = input_channels
        for i, n in enumerate(layer_nums):
            f = num_filters[i]
            self.add_module(f"block{i}_down_conv",
                            nn.Conv2d(c, f, 3, stride=layer_strides[i], bias=False))
            self.add_module(f"block{i}_down_bn", make_bn(f))
            for j in range(n):
                self.add_module(f"block{i}_layer{j}_conv", nn.Conv2d(f, f, 3, bias=False))
                self.add_module(f"block{i}_layer{j}_bn", make_bn(f))
            s = upsample_strides[i]
            self.add_module(f"deblock{i}_deconv", nn.ConvTranspose2d(
                f, num_upsample_filters[i], s, stride=s, bias=False))
            self.add_module(f"deblock{i}_bn", make_bn(num_upsample_filters[i]))
            c = f
        self.num_bev_features = sum(num_upsample_filters)

    def forward(self, batch_dict):
        x = batch_dict["spatial_features"]  # (B, C, H, W)
        ups = []
        for i, n in enumerate(self.layer_nums):
            for name in [f"block{i}_down"] + [f"block{i}_layer{j}" for j in range(n)]:
                x = torch.relu(bn_apply(conv_same(x, getattr(self, f"{name}_conv")),
                                       getattr(self, f"{name}_bn")))
            deconv = getattr(self, f"deblock{i}_deconv")
            u = F.conv_transpose2d(x, deconv.weight.to(x.dtype), stride=deconv.stride)
            ups.append(torch.relu(bn_apply(u, getattr(self, f"deblock{i}_bn"))))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        batch_dict["spatial_features_2d"] = x.float()
        return batch_dict
