"""Wrappers of the hand-written CUDA prefill attention kernel
(``csrc/prefill_attention.cu``; it replaces
``apex_tpu/ops/attention_pallas.py:230 _fwd_kernel`` and ``:262
_fwd_kernel_chunked``): :func:`prefill_attention` (K1) and
:func:`prefill_attention_dropout` (K1d, the kernel's dropout
instantiation, ``_fwd_kernel``'s dropout branch ``:252-256``).

For bf16 and fp16 both products run on the tensor cores
(``prefill_attention_tc``: Hopper's ``wgmma`` with fp32 accumulators,
K/V tiles brought in by ``cp.async`` into a two-stage ring of swizzled
shared tiles, P fed from the accumulators as the register operand of the
value product); fp32 runs on the CUDA cores (``prefill_attention_simt``),
where TF32 would not hold fp32's band. The source's header says what
bounds the kernel and how its design answers that.

Each wrapper checks its inputs (one device and dtype, contiguous; bf16
and fp16 16-byte aligned; head dim at most 256), zero-pads a head dim the
kernel is not built for up to the next one it is
(:func:`apex_tpu_torch.ops.attention._pad_head_dim`; exact, the scale
comes from the caller) and slices the result back, allocates the
output, launches on PyTorch's current stream without synchronising,
raises on a refused launch, and counts the launch in
``<wrapper>.launches`` (a plain int; a caller resets it to 0 before the
run it wants to read), so K1 and K1d launches are told apart. The plain
version is :func:`apex_tpu_torch.ops.attention._dense_attention`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.attention import (MAX_HEAD_DIM, _kernel_head_dim,
                                          _pad_head_dim, _slice_head_dim,
                                          dropout_scale, dropout_threshold)

_NAME = "prefill_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


_SIGNATURES = {
    "prefill_attention_fwd": ([_P] * 7 + [_I] * 5 + [_F, _I, ctypes.c_uint,
                                                     _F, _I, _I, _P], _I),
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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"prefill_attention: head_dim {d} (the kernels "
                         f"take up to {MAX_HEAD_DIM})")
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


def check_aligned(kernel, **tensors):
    """The tensor-core kernels move rows in 16-byte pieces."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             f"boundary")


# the launch arguments (seed pointer, threshold, scale) of no dropout
NO_DROPOUT = (None, 0, 0.0)


def dropout_args(dropout_p, dropout_seed, device):
    """``(seed pointer, threshold, scale)`` of a dropout launch: the seed
    checked to be an int32 ``[1]`` tensor on ``device`` (the kernels read
    it there), the threshold and scale of
    :func:`apex_tpu_torch.ops.attention.dropout_mscale`."""
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"dropout_p={dropout_p} outside (0, 1)")
    t = dropout_seed
    if (not torch.is_tensor(t) or t.device != device or t.dtype != torch.int32
            or tuple(t.shape) != (1,) or not t.is_contiguous()):
        raise ValueError(f"dropout_seed must be a contiguous int32 [1] tensor "
                         f"on {device}")
    return t.data_ptr(), dropout_threshold(dropout_p), dropout_scale(dropout_p)


def _launch(q, k, v, causal, sm_scale, segment_ids, drop):
    _check(q, k, v, segment_ids)
    if q.dtype != torch.float32:
        check_aligned("prefill_attention", q=q, k=k, v=v)
    d_true = q.shape[-1]
    width = _kernel_head_dim(d_true)
    q, k, v = (_pad_head_dim(t, width) for t in (q, k, v))
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    seg_q, seg_kv = (segment_ids[0].data_ptr(), segment_ids[1].data_ptr()) \
        if segment_ids is not None else (None, None)
    seed, thresh, mscale = drop
    _build.launch(_NAME, _SIGNATURES, "prefill_attention_fwd", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q, seg_kv,
                  seed, out.data_ptr(), b, h, sq, k.shape[2], d,
                  float(sm_scale), int(bool(causal)), thresh, mscale,
                  _build.DTYPE_CODES[q.dtype])
    return _slice_head_dim(out, d_true)


def prefill_attention(q, k, v, *, causal, sm_scale, segment_ids=None):
    """K1 on ``[b, h, s, d]`` CUDA tensors (see the module docstring);
    returns a new ``[b, h, sq, d]`` tensor."""
    out = _launch(q, k, v, causal, sm_scale, segment_ids, NO_DROPOUT)
    prefill_attention.launches += 1
    return out


def prefill_attention_dropout(q, k, v, *, causal, sm_scale, dropout_p,
                              dropout_seed, segment_ids=None):
    """K1d: K1 with inverted dropout on the probabilities, its mask drawn
    in the kernel from ``dropout_seed`` (an int32 ``[1]`` tensor on q's
    device) and the scores' global coordinates."""
    drop = dropout_args(dropout_p, dropout_seed, q.device)
    out = _launch(q, k, v, causal, sm_scale, segment_ids, drop)
    prefill_attention_dropout.launches += 1
    return out


prefill_attention.launches = 0
prefill_attention_dropout.launches = 0
