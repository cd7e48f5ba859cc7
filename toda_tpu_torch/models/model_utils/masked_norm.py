"""BatchNorm over padded sparse rows: statistics from valid rows only.

Counterpart of ``toda_tpu/models/model_utils/masked_norm.py``
(``MaskedBatchNorm``), in eval mode: the running statistics fold into one
per-channel affine applied in x's dtype, with the shift rounded to that
dtype first (:46-49), and rows outside the mask are zero. Training-mode
statistics come with the PartA2 training slice. Parameter and buffer names
follow flax's BatchNorm as the port's other norms do.
"""

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    eps = 1e-3  # the JAX MaskedBatchNorm's epsilon

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, mask):
        """x (..., C); mask broadcastable to x's shape without its channel
        dim. Returns (x * inv + shift) where mask, else 0."""
        if self.training:
            raise NotImplementedError("MaskedBatchNorm: training mode is not ported yet")
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = (self.bias - self.running_mean * inv).to(x.dtype)
        y = x * inv.to(x.dtype) + shift
        return y.masked_fill_(~mask[..., None], 0)


def add_fc_stack(owner, tag, in_channels, widths):
    """Adds ``{tag}_fc{i}`` (Linear, no bias) and ``{tag}_bn{i}``
    (MaskedBatchNorm) for each width to ``owner``, under the flax heads'
    names. Returns the stack's output width."""
    for i, ch in enumerate(int(w) for w in widths):
        owner.add_module(f"{tag}_fc{i}", nn.Linear(in_channels, ch, bias=False))
        owner.add_module(f"{tag}_bn{i}", MaskedBatchNorm(ch))
        in_channels = ch
    return in_channels


def fc_stack(owner, tag, x, mask):
    """x through ``owner``'s ``tag`` stack of ``add_fc_stack``: relu of the
    masked BatchNorm of each Linear."""
    i = 0
    while hasattr(owner, f"{tag}_fc{i}"):
        x = torch.relu(getattr(owner, f"{tag}_bn{i}")(getattr(owner, f"{tag}_fc{i}")(x), mask))
        i += 1
    return x
