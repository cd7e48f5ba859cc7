"""CenterPoint losses: the port's own copies of ``focal_loss_centernet`` and
``reg_loss_centernet`` from ``toda_tpu/utils/loss_utils.py`` (:104-140)."""

import torch


def focal_loss_centernet(pred, gt):
    """Penalty-reduced pixelwise focal loss for CenterPoint heatmaps.

    Args:
        pred: (B, H, W, C) sigmoid probabilities (clipped here).
        gt: (B, H, W, C) gaussian-splatted targets in [0, 1].
    Returns a scalar tensor.
    """
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt, 4)
    pred = torch.clamp(pred, 1e-4, 1 - 1e-4)
    pos_loss = (torch.log(pred) * torch.pow(1 - pred, 2) * pos_inds).sum()
    neg_loss = (torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * neg_inds).sum()
    num_pos = pos_inds.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_loss_centernet(pred_feat, target, ind, mask):
    """L1 regression at sparse target locations.

    Args:
        pred_feat: (B, H*W, D) flattened prediction map.
        target: (B, K, D) regression targets.
        ind: (B, K) int flat spatial indices.
        mask: (B, K) validity.
    Returns a scalar tensor.
    """
    gathered = torch.gather(pred_feat, 1, ind.long()[..., None].expand(-1, -1, pred_feat.shape[-1]))
    target = torch.where(torch.isnan(target), gathered, target)
    loss = torch.abs(gathered - target) * mask[..., None].to(pred_feat.dtype)
    return loss.sum() / torch.clamp(mask.sum().to(pred_feat.dtype), min=1.0)
