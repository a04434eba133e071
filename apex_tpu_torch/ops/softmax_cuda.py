"""Wrappers of the hand-written CUDA fused softmax kernels
(``csrc/softmax.cu``): K10 :func:`softmax_fwd` replaces
``apex_tpu/ops/softmax_pallas.py:185`` (``_fwd :159``, kernel
``_fwd_kernel :106``) and K11 :func:`softmax_bwd` replaces ``:212``
(``_bwd_rule :204``, kernel ``_bwd_kernel :130``). The source's header
says what bounds them (bytes) and how the design answers that.

Each wrapper checks its inputs, allocates its output, launches on
PyTorch's current stream without synchronising, raises on a refused
launch, and counts the launch in ``<wrapper>.launches`` (a plain int; a
caller resets it to 0 before the run it wants to read). The plain
versions are in :mod:`apex_tpu_torch.ops.softmax`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "softmax"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "softmax_fwd": ([_P, _P, _P, _L, _I, _I, _I, _L, _L, _L, _F, _I, _I,
                     _I, _P], _I),
    "softmax_bwd": ([_P, _P, _P, _L, _I, _F, _I, _I, _P], _I),
    "softmax_error_string": ([_I], ctypes.c_char_p),
}
MAX_SK = 4096


def _check_x(name, x):
    if x.dim() != 4 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous 4-D [b, np, sq, sk] "
                         f"CUDA tensor, got {tuple(x.shape)} on {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} (want bf16/fp16/fp32)")
    if not 1 <= x.shape[-1] <= MAX_SK or x.numel() == 0:
        raise ValueError(f"{name}: sk {x.shape[-1]} (the kernels take 1 to "
                         f"{MAX_SK} keys)")


def softmax_fwd(x, mask, scale, causal):
    """K10 on a ``[b, np, sq, sk]`` CUDA tensor: ``softmax(scale * x)`` with
    the causal triangle and/or ``mask`` (None, or a contiguous bool/int8
    ``[b|1, np|1, sq|1, sk]`` tensor, nonzero = masked, broadcast by index
    along its axes of size 1) forced to 0; returns y in x's dtype."""
    _check_x("softmax_fwd", x)
    b, np_, sq, sk = x.shape
    msb = msh = msq = 0
    mptr = None
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.int8) \
                or mask.device != x.device or not mask.is_contiguous() \
                or mask.dim() != 4 or mask.shape[-1] != sk \
                or any(m not in (1, n) for m, n in zip(mask.shape, x.shape)):
            raise ValueError(f"softmax_fwd: mask must be a contiguous bool or "
                             f"int8 [{b}|1, {np_}|1, {sq}|1, {sk}] tensor on "
                             f"{x.device}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        # an axis of size 1 is read at stride 0; the others are multiples
        # of sk, so every mask row starts where a 16-byte load may
        msb, msh, msq, _ = mask.expand(b, np_, sq, sk).stride()
        mptr = mask.data_ptr()
    y = torch.empty_like(x)
    _build.launch(_NAME, _SIGNATURES, "softmax_fwd", x.device, x.data_ptr(),
                  mptr, y.data_ptr(), b * np_ * sq, sq, sk, np_, msb, msh, msq,
                  float(scale), int(bool(causal)),
                  _build.DTYPE_CODES[x.dtype])
    softmax_fwd.launches += 1
    return y


def softmax_bwd(y, g, scale):
    """K11: ``scale * y * (g - sum(g * y))`` over the last axis of ``[b, np,
    sq, sk]`` CUDA tensors ``y`` (the forward's output) and ``g`` (its
    cotangent, same dtype and shape); returns dx in y's dtype."""
    _check_x("softmax_bwd", y)
    if g.dtype != y.dtype or g.shape != y.shape or g.device != y.device \
            or not g.is_contiguous():
        raise ValueError(f"softmax_bwd: g must be a contiguous {y.dtype} "
                         f"{tuple(y.shape)} tensor on {y.device}")
    b, np_, sq, sk = y.shape
    dx = torch.empty_like(y)
    _build.launch(_NAME, _SIGNATURES, "softmax_bwd", y.device, y.data_ptr(),
                  g.data_ptr(), dx.data_ptr(), b * np_ * sq, sk, float(scale),
                  _build.DTYPE_CODES[y.dtype])
    softmax_bwd.launches += 1
    return dx


softmax_fwd.launches = 0
softmax_bwd.launches = 0
