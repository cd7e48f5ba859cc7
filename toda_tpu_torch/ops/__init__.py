"""Device ops of the port. The CUDA kernels (``csrc/``) sit behind
``fused_conv.fused_bnconv9`` (K1) and its backward (K2, K3),
``gather.scatter_rows_add`` (K4), ``gather.unpack_pillars`` (K5),
``gather.gather_rows`` (K6), ``gather.gather9_stacked_t`` (K7),
``gather.gather_rows_taps_t`` (K8) and ``gather.gather_rows_taps`` (K9)."""
