"""Anchor box coder.

Counterpart of ``toda_tpu/utils/box_coder_utils.py`` (``ResidualCoder``
:10-72) for 7-channel boxes: encode (the anchor head's regression targets)
and decode. The sin/cos heading code comes with the multi-head anchor head
that uses it.
"""

import torch


class ResidualCoder:
    """Anchor-relative residual boxes (SECOND / PointPillars / PartA2), 7
    channels: x y z dx dy dz heading."""

    code_size = 7

    def encode(self, boxes, anchors):
        """(..., 7) boxes + (..., 7) anchors -> (..., 7) residuals (:23-49);
        sizes are clamped to 1e-5 before the ratios."""
        dxa, dya, dza = (torch.clamp(anchors[..., i], min=1e-5) for i in (3, 4, 5))
        dxg, dyg, dzg = (torch.clamp(boxes[..., i], min=1e-5) for i in (3, 4, 5))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (boxes[..., 0] - anchors[..., 0]) / diag,
            (boxes[..., 1] - anchors[..., 1]) / diag,
            (boxes[..., 2] - anchors[..., 2]) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
            boxes[..., 6] - anchors[..., 6],
        ], dim=-1)

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
