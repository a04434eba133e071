"""Wrapper of the hand-written W8A16 decode matmul (``csrc/qmatmul.cu``):
K23 :func:`qmatmul`. It replaces no Pallas site: the JAX package
contracts the int8 weight in XLA (``apex_tpu/serving/quant.py:77``); the
source's header says what bounds it (bytes) and how the design answers
that.

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on PyTorch's current stream without
synchronising, raises on a refused launch, and counts each launch in
``qmatmul.launches`` (a plain int; a caller resets it to 0 before the run
it wants to read). The plain version is ``ops/qmatmul.qmatmul_reference``.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "qmatmul"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "qmatmul_w8a16": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "qmatmul_error_string": ([_I], ctypes.c_char_p),
}
VEC = 16          # csrc/qmatmul.cu VEC: K is a multiple of it
MAX_ROWS = 65535 * 8


def qmatmul(x, wq, scale):
    """K23: ``y [B, N] = (x [B, K] @ wq [N, K]^T) * scale [N]`` in
    ``x``'s dtype (bf16, fp16 or fp32), accumulated in fp32, the scale on
    the fp32 output columns, one rounding. ``wq`` int8 with K a multiple of
    16 and 16-byte aligned, ``scale`` fp32; all contiguous on one CUDA
    device."""
    name = "qmatmul"
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name}: want x [B, K], wq [N, K], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(scale.shape)}")
    dev = x.device
    (B, K), N = x.shape, wq.shape[0]
    for what, t, dtypes in (("x", x, tuple(_build.DTYPE_CODES)),
                            ("wq", wq, (torch.int8,)),
                            ("scale", scale, (torch.float32,))):
        if not t.is_cuda or t.device != dev or not t.is_contiguous() \
                or t.dtype not in dtypes:
            raise ValueError(f"{name}: want {what} a contiguous tensor of "
                             f"{dtypes} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if wq.shape[1] != K or scale.shape[0] != N:
        raise ValueError(f"{name}: x {tuple(x.shape)}, wq {tuple(wq.shape)} "
                         f"and scale {tuple(scale.shape)} do not agree")
    if K % VEC or wq.data_ptr() % 16 or not 0 < B <= MAX_ROWS or N < 1:
        raise ValueError(f"{name}: the kernel takes K a multiple of {VEC}, "
                         f"a 16-byte aligned wq and 1 to {MAX_ROWS} rows; got "
                         f"K {K}, B {B}, wq at {wq.data_ptr():#x}")
    y = torch.empty((B, N), dtype=x.dtype, device=dev)
    _build.launch(_NAME, _SIGNATURES, "qmatmul_w8a16", dev, x.data_ptr(),
                  wq.data_ptr(), scale.data_ptr(), y.data_ptr(), B, N, K,
                  _build.DTYPE_CODES[x.dtype])
    qmatmul.launches += 1
    return y


qmatmul.launches = 0
