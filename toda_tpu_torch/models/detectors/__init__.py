from .detector3d import build_detector

__all__ = ["build_detector"]
