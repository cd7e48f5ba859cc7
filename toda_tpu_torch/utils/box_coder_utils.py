"""Anchor box coder.

Counterpart of ``toda_tpu/utils/box_coder_utils.py`` (``ResidualCoder``),
decode only: the encode comes with the anchor-head training slice, the
sin/cos heading code with the multi-head anchor head that uses it.
"""

import torch


class ResidualCoder:
    """Anchor-relative residual boxes (SECOND / PointPillars / PartA2), 7
    channels: x y z dx dy dz heading."""

    code_size = 7

    def decode(self, encodings, anchors):
        """(..., 7) residuals + (..., 7) anchors -> (..., 7) boxes."""
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = encodings[..., 0] * diag + anchors[..., 0]
        yg = encodings[..., 1] * diag + anchors[..., 1]
        zg = encodings[..., 2] * dza + anchors[..., 2]
        dxg = torch.exp(encodings[..., 3]) * dxa
        dyg = torch.exp(encodings[..., 4]) * dya
        dzg = torch.exp(encodings[..., 5]) * dza
        rg = encodings[..., 6] + anchors[..., 6]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)
