"""Wrappers of the hand-written CUDA fused softmax kernels
(``csrc/softmax.cu``): K10 :func:`softmax_fwd` replaces
``apex_tpu/ops/softmax_pallas.py:185`` (``_fwd :159``, kernel
``_fwd_kernel :106``) and K11 :func:`softmax_bwd` replaces ``:212``
(``_bwd_rule :204``, kernel ``_bwd_kernel :130``), for rows of up to
4096 keys; K10L :func:`softmax_fwd_long` and K11L :func:`softmax_bwd_long`
compute the same functions for rows of any length (the generic softmax's
``sk > 4096``), one block per row, K10L in the body :func:`long_plan`
names. The source's header says what bounds them (bytes) and how the
design answers that.

Each wrapper checks its inputs, allocates its output, launches on
PyTorch's current stream without synchronising, raises on a refused
launch, and counts the launch in ``<wrapper>.launches`` (a plain int; a
caller resets it to 0 before the run it wants to read). The plain
versions are in :mod:`apex_tpu_torch.ops.softmax`.
"""

import ctypes
from collections import namedtuple

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
    "softmax_fwd_long": ([_P, _P, _P, _L, _I, _I, _I, _L, _L, _L, _F, _I,
                          _I, _I, _I, _I, _I, _P], _I),
    "softmax_bwd_long": ([_P, _P, _P, _L, _I, _F, _I, _I, _P], _I),
    "softmax_error_string": ([_I], ctypes.c_char_p),
}
# the longest row K10/K11 take (one warp holds it in registers); K10L and
# K11L take any length, at most 2**31 - 1 rows (one block per row)
MAX_SK = 4096
_MAX_LONG_ROWS = 2 ** 31 - 1
# K10L's bodies (csrc/softmax.cu): fp32 values a thread of the regs body
# holds and its most threads, the vectors a thread of the smem body stages,
# the most threads a block, and the smem body's largest stage (a 16-byte
# slot and a byte of mask bits a vector: two blocks an SM)
LONG_REG_VALUES = 32
LONG_REG_THREADS = 256
LONG_SMEM_VECS = 8
LONG_MAX_THREADS = 512
LONG_SMEM_MAX = 102 * 1024
LONG_BODIES = ("regs", "smem", "walk")
LongPlan = namedtuple("LongPlan", "body threads smem")


def long_plan(sk, itemsize):
    """K10L's body for rows of ``sk`` keys of ``itemsize`` bytes, from the
    length and the dtype's size alone (the fastest an H100 measured,
    ``chip_smoke.py``'s K10L phase): ``regs`` for bf16/fp16 rows of up to
    ``LONG_REG_THREADS`` threads of ``LONG_REG_VALUES`` values (8192 keys:
    the row in registers, the fewest warps that cover it); ``smem`` while
    the row's stage fits ``LONG_SMEM_MAX`` (49152 bf16/fp16 or 24576 fp32
    keys; fp32 from the first long row, where it beat an fp32 register
    body, which the C entry refuses),
    ``LONG_SMEM_VECS`` vectors a thread up to ``LONG_MAX_THREADS``;
    ``walk`` past it (an online max and sum, two reads). Returns
    ``LongPlan(body, threads, smem)``, ``smem`` the dynamic shared bytes.
    """
    if sk < 1 or itemsize not in (2, 4):
        raise ValueError(f"long_plan: sk {sk}, itemsize {itemsize}")
    nvec = -(-sk // (16 // itemsize))
    per_thread = LONG_REG_VALUES * itemsize // 16
    if itemsize == 2 and nvec <= per_thread * LONG_REG_THREADS:
        return LongPlan("regs", 32 * -(-nvec // (32 * per_thread)), 0)
    smem = -(-(nvec * 17) // 16) * 16
    if smem <= LONG_SMEM_MAX:
        threads = min(LONG_MAX_THREADS,
                      32 * -(-nvec // (32 * LONG_SMEM_VECS)))
        return LongPlan("smem", threads, smem)
    return LongPlan("walk", LONG_MAX_THREADS, 0)


def _check_x(name, x, long):
    if x.dim() != 4 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous 4-D [b, np, sq, sk] "
                         f"CUDA tensor, got {tuple(x.shape)} on {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} (want bf16/fp16/fp32)")
    if x.numel() == 0 or (not long and x.shape[-1] > MAX_SK):
        raise ValueError(f"{name}: sk {x.shape[-1]} (the kernel takes 1 to "
                         f"{MAX_SK} keys; the long-row kernels any)")
    rows = x.numel() // x.shape[-1]
    if long and rows > _MAX_LONG_ROWS:
        raise ValueError(f"{name}: {rows} rows (at most {_MAX_LONG_ROWS})")
    return rows


def softmax_fwd(x, mask, scale, causal):
    """K10 on a ``[b, np, sq, sk]`` CUDA tensor: ``softmax(scale * x)`` with
    the causal triangle and/or ``mask`` (None, or a contiguous bool/int8
    ``[b|1, np|1, sq|1, sk]`` tensor, nonzero = masked, broadcast by index
    along its axes of size 1) forced to 0; returns y in x's dtype."""
    y = _fwd("softmax_fwd", x, mask, scale, causal, False)
    softmax_fwd.launches += 1
    return y


def softmax_fwd_long(x, mask, scale, causal):
    """K10L: :func:`softmax_fwd`'s function for rows of any length, in the
    body :func:`long_plan` names."""
    y = _fwd("softmax_fwd_long", x, mask, scale, causal, True)
    softmax_fwd_long.launches += 1
    return y


def _fwd(name, x, mask, scale, causal, long):
    rows = _check_x(name, x, long)
    b, np_, sq, sk = x.shape
    msb = msh = msq = 0
    mptr = None
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.int8) \
                or mask.device != x.device or not mask.is_contiguous() \
                or mask.dim() != 4 or mask.shape[-1] != sk \
                or any(m not in (1, n) for m, n in zip(mask.shape, x.shape)):
            raise ValueError(f"{name}: mask must be a contiguous bool or "
                             f"int8 [{b}|1, {np_}|1, {sq}|1, {sk}] tensor on "
                             f"{x.device}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        # an axis of size 1 is read at stride 0; the others are multiples
        # of sk, so every mask row starts where a 16-byte load may
        msb, msh, msq, _ = mask.expand(b, np_, sq, sk).stride()
        mptr = mask.data_ptr()
    y = torch.empty_like(x)
    plan = ()
    if long:
        p = long_plan(sk, x.element_size())
        plan = (LONG_BODIES.index(p.body), p.threads, p.smem)
    _build.launch(_NAME, _SIGNATURES, name, x.device, x.data_ptr(), mptr,
                  y.data_ptr(), rows, sq, sk, np_, msb, msh, msq,
                  float(scale), int(bool(causal)), *plan,
                  _build.DTYPE_CODES[x.dtype])
    return y


def softmax_bwd(y, g, scale):
    """K11: ``scale * y * (g - sum(g * y))`` over the last axis of ``[b, np,
    sq, sk]`` CUDA tensors ``y`` (the forward's output) and ``g`` (its
    cotangent, same dtype and shape); returns dx in y's dtype."""
    dx = _bwd("softmax_bwd", y, g, scale, False)
    softmax_bwd.launches += 1
    return dx


def softmax_bwd_long(y, g, scale):
    """K11L: :func:`softmax_bwd`'s function for rows of any length."""
    dx = _bwd("softmax_bwd_long", y, g, scale, True)
    softmax_bwd_long.launches += 1
    return dx


def _bwd(name, y, g, scale, long):
    rows = _check_x(name, y, long)
    if g.dtype != y.dtype or g.shape != y.shape or g.device != y.device \
            or not g.is_contiguous():
        raise ValueError(f"{name}: g must be a contiguous {y.dtype} "
                         f"{tuple(y.shape)} tensor on {y.device}")
    sk = y.shape[-1]
    dx = torch.empty_like(y)
    _build.launch(_NAME, _SIGNATURES, name, y.device, y.data_ptr(),
                  g.data_ptr(), dx.data_ptr(), rows, sk, float(scale),
                  _build.DTYPE_CODES[y.dtype])
    return dx


softmax_fwd.launches = 0
softmax_bwd.launches = 0
softmax_fwd_long.launches = 0
softmax_bwd_long.launches = 0
