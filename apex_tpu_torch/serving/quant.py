"""int8 weight quantization for the serving decode matmuls (counterpart of
``apex_tpu/serving/quant.py``).

Decode is bandwidth-bound: every step streams the whole weight set for
one token a sequence. Stored as int8 with per-output-channel fp32 scales,
the matmul weights move half the bytes of bf16; K23 (``ops/qmatmul``)
reads the int8 rows and applies the scale to the output columns, so no
dequantized weight is ever written.

Knob: ``APEX_SERVE_WEIGHT_QUANT`` in {"1", "0"} (a preference: unknown
values warn once and are ignored), :func:`set_weight_quant` the
process-wide setter, and the engine's per-call ``weight_quant=``, which
raises on a request it cannot honor (a word table that is not floating
point). Default off, as in the JAX package.
"""

import torch

from apex_tpu_torch import _env, device_scalar
from apex_tpu_torch.ops.qmatmul import qmatmul  # noqa: F401

_QUANT = None  # the process-wide tri-state preference


def set_weight_quant(value):
    """Pin the process-wide preference (True/False), or unpin it with None
    (the environment, then the default, apply). A non-bool raises."""
    global _QUANT
    if value is not None and not isinstance(value, bool):
        raise ValueError(
            f"set_weight_quant wants True/False/None, got {value!r}")
    _QUANT = value


def resolve(per_call=None):
    """The effective decision: the per-call value (validated by the
    caller), then the setter, then ``APEX_SERVE_WEIGHT_QUANT``, then off."""
    if per_call is not None:
        return bool(per_call)
    if _QUANT is not None:
        return _QUANT
    v = _env.env_choice("APEX_SERVE_WEIGHT_QUANT", ("1", "0"))
    if v is not None:
        return v == "1"
    return False


def quantizable(w):
    """Whether a weight can take the int8 path: a floating-point tensor."""
    return isinstance(w, torch.Tensor) and w.is_floating_point()


def quantize_weight(w):
    """``(wq int8 [out, in], scale fp32 [out])``: symmetric per-output-
    channel quantization of an ``[out, in]`` matmul weight, JAX's codes and
    scales bit for bit. An all-zero row gets scale 0 and codes 0. Both
    divisions are true divisions by tensors on ``w``'s device."""
    if not quantizable(w):
        raise ValueError(
            f"cannot int8-quantize dtype {getattr(w, 'dtype', None)}")
    wf = w.float()
    amax = wf.abs().amax(dim=1)
    scale = amax / device_scalar(127.0, wf)
    live = scale > 0
    inv = torch.where(live, torch.ones_like(scale)
                      / torch.where(live, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    wq = torch.clamp(torch.round(wf * inv[:, None]), -127, 127).to(
        torch.int8)
    return wq, scale
