"""PyTorch / CUDA port of ``toda_tpu`` for NVIDIA Hopper (H100).

Mirrors ``toda_tpu``'s module paths. Imports torch and numpy, never JAX and
nothing of ``toda_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""
