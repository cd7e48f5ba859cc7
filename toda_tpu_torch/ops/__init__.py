"""Device ops of the port. The CUDA kernels (``csrc/``) sit behind
``gather.scatter_rows_add`` (K4), ``gather.unpack_pillars`` (K5) and
``fused_conv.fused_bnconv9`` (K1)."""
