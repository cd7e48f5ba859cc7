"""The whole CenterPoint-Res slice in bf16: the PyTorch port against the JAX
package on the same carried weights and batch (setup in test_torch_model.py).
"""

import numpy as np
from test_torch_model import run_both


def test_bf16_head_outputs_loosely():
    """bf16 rounds at other places in the two frameworks (JAX rounds the
    pending BatchNorm affine to bf16 before applying it, the port's fused conv
    applies it in f32 and rounds the activation), and the differences grow
    over ~30 layers: BEV features and head outputs agree to 0.05 of each
    output's largest magnitude (measured: 0.011-0.016)."""
    (jsf, jheads), (psf, pheads) = run_both(bf16=True, decode=False)
    for name, j, p in [("bev", jsf, psf)] + [(k, jheads[k], pheads[k]) for k in jheads]:
        j = np.asarray(j, np.float32)
        scale = max(1.0, float(np.abs(j).max()))
        err = float(np.abs(p - j).max())
        assert err <= 0.05 * scale, (name, err, scale)
