"""Detection losses: the port's own copies of the anchor head's
``sigmoid_focal_cls_loss``, ``smooth_l1_loss``, ``weighted_smooth_l1_loss``
and ``weighted_cross_entropy_loss`` (:14-69) and CenterPoint's
``focal_loss_centernet`` and ``reg_loss_centernet`` (:104-140) from
``toda_tpu/utils/loss_utils.py``. In a data-parallel run the CenterPoint
losses divide by the global batch's counts (``parallel.mesh.global_count``),
so each rank's value is its share of the global batch's loss."""

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_count


def sigmoid_focal_cls_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Per-element sigmoid focal loss. logits, targets (..., C) (targets
    one-hot {0, 1}); weights (...,) or (..., C). Returns (..., C)."""
    pred = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - pred) + (1.0 - targets) * pred
    bce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    loss = alpha_weight * torch.pow(pt, gamma) * bce
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def smooth_l1_loss(diff, beta=1.0 / 9.0):
    n = diff.abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def weighted_smooth_l1_loss(preds, targets, weights=None, beta=1.0 / 9.0, code_weights=None):
    """(..., D) box-regression smooth-L1 with optional per-dim code weights
    and per-row weights (...,); NaN targets count as matched."""
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    loss = smooth_l1_loss(diff, beta)
    return loss if weights is None else loss * weights[..., None]


def weighted_cross_entropy_loss(logits, targets, weights):
    """(..., C) logits vs (..., C) one-hot targets, times weights (...,)."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1) * weights


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
    num_pos = global_count(pos_inds.sum())
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
    return loss.sum() / torch.clamp(global_count(mask.sum().to(pred_feat.dtype)), min=1.0)
