"""Dense BEV backbone: strided conv stages + upsample-and-concat, eval mode.

Counterpart of ``toda_tpu/models/backbones_2d/base_bev_backbone.py`` in NCHW.
Module names mirror the flax ones (``block{i}_down_conv`` ...). Two flax
conventions are reproduced explicitly:
  * ``padding="SAME"`` with stride 2 pads (0, 1) on an even map, not (1, 1):
    the input is padded as flax pads it, then convolved without padding;
  * flax ``ConvTranspose`` with kernel == stride gives out[s*i + a] =
    x[i] * W[s-1-a]; ``weights.state_dict_from_flax`` flips the kernel so that
    ``nn.ConvTranspose2d`` computes the same.
The blocks compute in the input's dtype (bf16 when the 3D backbone runs in
bf16, as in JAX); the output is f32.
"""

import torch
import torch.nn.functional as F
from torch import nn


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


def bn_eval(x, bn):
    """Inference BatchNorm as one per-channel affine in x's dtype."""
    if bn.training:
        raise NotImplementedError("batch-statistics BatchNorm comes with the training slice")
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def make_bn(c):
    return nn.BatchNorm2d(c, eps=1e-3, momentum=0.01)


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
                x = torch.relu(bn_eval(conv_same(x, getattr(self, f"{name}_conv")),
                                       getattr(self, f"{name}_bn")))
            deconv = getattr(self, f"deblock{i}_deconv")
            u = F.conv_transpose2d(x, deconv.weight.to(x.dtype), stride=deconv.stride)
            ups.append(torch.relu(bn_eval(u, getattr(self, f"deblock{i}_bn"))))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        batch_dict["spatial_features_2d"] = x.float()
        return batch_dict
