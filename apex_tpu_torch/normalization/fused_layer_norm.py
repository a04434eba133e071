"""FusedLayerNorm (counterpart of
``apex_tpu/normalization/fused_layer_norm.py``).

:func:`fused_layer_norm` normalizes over the trailing ``normalized_shape``
with fp32 statistics and fp32 affine math, and returns the input dtype.
It runs the row layer norm of :mod:`apex_tpu_torch.ops.layer_norm` on
rows of width ``prod(normalized_shape)`` (several normalized axes are
one flattened row, weight and bias flattened alike): K3/K4 on a CUDA
tensor (the JAX package's ``use_pallas=True`` route, ``_resolve_pallas
:67``), the plain versions on a CPU tensor, which equal the jnp path
``:170-178``. There is no per-shape fallback on the card: the kernels
take rows of every width (JAX falls back to jnp where its kernel refuses
a shape, ``:73-74``, ``:114-115``).
"""

import math
import numbers

import torch
from torch import nn

from apex_tpu_torch import default_device
from apex_tpu_torch.ops.layer_norm import layer_norm


def _normalized_shape(normalized_shape):
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


def fused_layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
    """Layer norm of ``x`` over its trailing ``normalized_shape``;
    ``weight``/``bias`` of that shape or None. Output in ``x.dtype``."""
    shape = _normalized_shape(normalized_shape)
    n = len(shape)
    if tuple(x.shape[-n:]) != shape:
        raise ValueError(f"input tail {tuple(x.shape[-n:])} != "
                         f"normalized_shape {shape}")
    width = math.prod(shape)
    w = None if weight is None else weight.float().reshape(width)
    b = None if bias is None else bias.float().reshape(width)
    y2d = layer_norm(x.reshape(-1, width).contiguous(), w, b, eps)
    return y2d.reshape(x.shape)


class FusedLayerNorm(nn.Module):
    """Module surface of ``FusedLayerNorm``: parameters ``weight`` (ones)
    and ``bias`` (zeros) in ``param_dtype`` (fp32) when
    ``elementwise_affine``; the result is cast back to the input dtype.
    ``device=None`` means ``cuda``."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.normalized_shape = _normalized_shape(normalized_shape)
        self.eps = eps
        device = default_device(device)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        return fused_layer_norm(x, self.normalized_shape, self.weight,
                                self.bias, self.eps)
