"""Model layer: torch.nn detector modules assembled from config."""

from ..utils.common_utils import resolve_device
from .detectors import build_detector


def build_network(model_cfg, num_class, dataset, device=None, seed=0):
    """The detector bundle on ``device`` (CUDA unless the caller passes
    another; raises when CUDA is absent), initialised from ``seed``."""
    return build_detector(model_cfg=model_cfg, num_class=num_class, dataset=dataset,
                          device=resolve_device(device), seed=seed)
