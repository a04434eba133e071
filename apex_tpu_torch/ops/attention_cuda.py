"""Wrapper of the hand-written CUDA prefill attention kernel
(``csrc/prefill_attention.cu``; it replaces
``apex_tpu/ops/attention_pallas.py:230 _fwd_kernel`` and ``:262
_fwd_kernel_chunked``). The source's header says what bounds the kernel
and how its design answers that.

:func:`prefill_attention` checks its inputs, allocates the output,
launches on PyTorch's current stream without synchronising, raises on a
refused launch, and counts the launch in ``prefill_attention.launches``
(a plain int; a caller resets it to 0 before the run it wants to read).
The plain version is :func:`apex_tpu_torch.ops.attention._dense_attention`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "prefill_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int


_SIGNATURES = {
    "prefill_attention_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _I, _I, _P], _I),
    "prefill_attention_error_string": ([_I], ctypes.c_char_p),
}


def _check(q, k, v, segment_ids):
    tensors = [("q", q), ("k", k), ("v", v)]
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"prefill_attention: {name} must be a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in (
                torch.bfloat16, torch.float16, torch.float32):
            raise ValueError(f"prefill_attention: {name} dtype {t.dtype} "
                             f"(want one of bf16/fp16/fp32 for all of q,k,v)")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"prefill_attention: {name} must be a "
                             f"contiguous [b, h, s, d] tensor")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"prefill_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d not in (64, 128):
        raise ValueError(f"prefill_attention: head_dim {d} (the kernel "
                         f"takes 64 or 128)")
    if b * h > 65535:
        raise ValueError("prefill_attention: b * h exceeds the grid limit")
    if segment_ids is not None:
        for name, t, n in (("seg_q", segment_ids[0], sq),
                           ("seg_kv", segment_ids[1], sk)):
            if (t.device != q.device or t.dtype != torch.int32
                    or tuple(t.shape) != (b, n) or not t.is_contiguous()):
                raise ValueError(f"prefill_attention: {name} must be a "
                                 f"contiguous int32 [{b}, {n}] tensor on "
                                 f"{q.device}")


def prefill_attention(q, k, v, *, causal, sm_scale, segment_ids=None):
    """The kernel on ``[b, h, s, d]`` CUDA tensors (see the module
    docstring); returns a new ``[b, h, sq, d]`` tensor."""
    _check(q, k, v, segment_ids)
    lib = _build.load(_NAME, _SIGNATURES)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    seg_q, seg_kv = (segment_ids[0].data_ptr(), segment_ids[1].data_ptr()) \
        if segment_ids is not None else (None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.prefill_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q, seg_kv,
            out.data_ptr(), b, h, sq, k.shape[2], d, float(sm_scale),
            int(bool(causal)), _build.DTYPE_CODES[q.dtype],
            q.device.index, stream)
    _build.check(lib, _NAME, rc)
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
