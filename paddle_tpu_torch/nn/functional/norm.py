"""Normalisation functionals (counterpart of
`paddle_tpu/nn/functional/norm.py`)."""
from __future__ import annotations

from ...kernels import rms_norm as _krms


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim, output in x's dtype. A CUDA tensor goes to
    the CUDA kernel (which raises on what it does not take); a CPU tensor
    goes to the plain version."""
    return _krms.rms_norm(x, weight, epsilon)
