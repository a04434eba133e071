"""Wrappers of the hand-written CUDA codec kernels
(``csrc/collectives.cu``): K19 :func:`quantize` and K20
:func:`dequantize_sum`. They replace no Pallas site: the JAX package
computes the codec in jnp (``apex_tpu/parallel/collectives.py:269-331``
and the fp32 sums of ``:354-360``, ``:384-387``); the source's header
says what bounds them (bytes) and how the design answers that.

Each checks its inputs and raises on anything the kernel does not take,
allocates its outputs, launches on PyTorch's current stream without
synchronising, raises on a refused launch, and counts each launch in
``<wrapper>.launches`` (a plain int; a caller resets it to 0 before the
run it wants to read). The plain versions are
``ops/collectives.quantize_reference`` and ``dequantize_sum_reference``.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "collectives"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "collectives_quantize": ([_P, _P, _P, _P, _P, _L, _L, _L, _I, _P], _I),
    "collectives_dequantize": ([_P, _P, _P, _L, _L, _L, _L, _I, _F, _I, _P],
                               _I),
    "collectives_error_string": ([_I], ctypes.c_char_p),
}
BLOCK = 128   # the codec's default block (ops/collectives.DEFAULT_BLOCK)


def _check(name, t, dtype, dev, shape=None):
    if not t.is_cuda or t.device != dev or not t.is_contiguous() \
            or t.dtype != dtype:
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")


def quantize(x, residual=None, *, block=BLOCK):
    """K19 over fp32 ``x`` ``[R, n]`` or ``[n]`` (the residual, when
    given, of the same shape): returns ``(q [..., nb, block] int8, scales
    [..., nb] bf16, new_residual)``, the new residual a new tensor.
    Without ``residual`` no residual is written (None). ``block`` is any
    positive number of elements a scale, as JAX's ``quantize_blocks``
    takes."""
    name = "collectives quantize"
    if int(block) != block or block < 1:
        raise ValueError(f"{name}: block {block!r} (want a positive int)")
    block = int(block)
    if x.dim() not in (1, 2) or x.numel() == 0:
        raise ValueError(f"{name}: want a non-empty [n] or [R, n] tensor, "
                         f"got {tuple(x.shape)}")
    dev = x.device
    _check(name, x, torch.float32, dev)
    rows, n = (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)
    nb = -(-n // block)
    lead = tuple(x.shape[:-1])
    q = torch.empty(lead + (nb, block), dtype=torch.int8, device=dev)
    scales = torch.empty(lead + (nb,), dtype=torch.bfloat16, device=dev)
    rout = None
    if residual is not None:
        _check(name, residual, torch.float32, dev, x.shape)
        rout = torch.empty_like(x)
    _build.launch(_NAME, _SIGNATURES, "collectives_quantize", dev,
                  x.data_ptr(),
                  residual.data_ptr() if residual is not None else None,
                  rout.data_ptr() if rout is not None else None,
                  q.data_ptr(), scales.data_ptr(), rows, n, block)
    quantize.launches += 1
    return q, scales, rout


def dequantize_sum(q, scales, n, *, gather=False, divisor=None):
    """K20 over ``q`` ``[W, nb, block]`` int8 (any block) and ``scales``
    ``[W, nb]`` bf16: the fp32 sum over W in rank order of each rank's
    first ``n`` dequantized values, ``[n]``, divided by ``divisor`` (a
    number; a true division) when given; with ``gather`` their
    concatenation ``[W n]``."""
    name = "collectives dequantize_sum"
    if q.dim() != 3 or q.shape[2] < 1:
        raise ValueError(f"{name}: want q [W, nb, block], got "
                         f"{tuple(q.shape)}")
    dev = q.device
    world, nb, block = q.shape
    _check(name, q, torch.int8, dev)
    _check(name, scales, torch.bfloat16, dev, (world, nb))
    if not 0 < n <= nb * block:
        raise ValueError(f"{name}: n {n} outside (0, {nb * block}]")
    if divisor is not None and (gather or float(divisor) == 0.0):
        raise ValueError(f"{name}: a divisor needs the sum and is not 0")
    out = torch.empty((world * n,) if gather else (n,), dtype=torch.float32,
                      device=dev)
    _build.launch(_NAME, _SIGNATURES, "collectives_dequantize", dev,
                  q.data_ptr(), scales.data_ptr(), out.data_ptr(), world, nb,
                  n, block, int(bool(gather)),
                  0.0 if divisor is None else float(divisor))
    dequantize_sum.launches += 1
    return out


quantize.launches = 0
dequantize_sum.launches = 0
