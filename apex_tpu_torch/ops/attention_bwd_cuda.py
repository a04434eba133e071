"""Wrappers of the hand-written CUDA attention backward
(``csrc/attention_bwd.cu``; it replaces
``apex_tpu/ops/attention_pallas.py:850 _bwd_split``): K5
:func:`attention_bwd_dq` (the dq pass, ``:869``) and K6
:func:`attention_bwd_dkv` (the dk/dv pass, ``:899``); and their dropout
instantiations K5d :func:`attention_bwd_dq_dropout` and K6d
:func:`attention_bwd_dkv_dropout`, which compute the dropout replay of
the monolithic backward (``_bwd_kernel :303``, ``:331-346``, under
``pallas_call :834``) in the split structure.

For bf16 and fp16 every product of K5/K6 (and K5d/K6d) runs on the
tensor cores (``wgmma`` with fp32 accumulators, operands brought in
by ``cp.async`` into a two-stage ring of swizzled shared tiles), at
every head dim; at 256 a block has two warpgroups (K5: 64 q rows each;
K6: one holding dv, the other dk). fp32 runs on the CUDA cores, where
TF32 would not hold fp32's band. The source's header says what bounds
them and how the design answers that.

Each wrapper checks its inputs (one device and dtype, contiguous,
16-byte aligned; head dim at most 256), zero-pads a head dim the kernels
are not built for up to the next one they are (exact; the autograd path
of :func:`apex_tpu_torch.ops.attention.fused_attention` hands them
tensors it padded once in the forward), slices the gradients back,
allocates its outputs, launches on PyTorch's current stream without
synchronising, raises on a refused launch, and counts the launch in
``<wrapper>.launches`` (a plain int; a caller resets it to 0 before the
run it wants to read). :func:`attention_bwd` runs K5 then K6,
:func:`attention_bwd_dropout` K5d then K6d. The plain version is
:func:`apex_tpu_torch.ops.attention._attention_bwd_split`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.attention import (_kernel_head_dim, _pad_head_dim,
                                          _slice_head_dim)
from apex_tpu_torch.ops.attention_cuda import (NO_DROPOUT, _check,
                                               check_aligned, dropout_args)

_NAME = "attention_bwd"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TAIL = [_I] * 5 + [_F, _I, ctypes.c_uint, _F, _I, _I, _P]
_SIGNATURES = {
    "attention_bwd_dq": ([_P] * 12 + _TAIL, _I),
    "attention_bwd_dkv": ([_P] * 12 + _TAIL, _I),
    "attention_bwd_error_string": ([_I], ctypes.c_char_p),
}


def _seg_ptrs(segment_ids):
    if segment_ids is None:
        return None, None
    return segment_ids[0].data_ptr(), segment_ids[1].data_ptr()


def _check_like(name, t, ref):
    if (t.device != ref.device or t.dtype != ref.dtype
            or t.shape != ref.shape or not t.is_contiguous()):
        raise ValueError(f"attention_bwd: {name} must be a contiguous "
                         f"{ref.dtype} {tuple(ref.shape)} tensor on "
                         f"{ref.device}")


def _dq(q, k, v, o, do, causal, sm_scale, segment_ids, drop):
    _check(q, k, v, segment_ids)
    _check_like("o", o, q)
    _check_like("do", do, q)
    check_aligned("attention_bwd", q=q, k=k, v=v, o=o, do=do)
    d_true = q.shape[-1]
    width = _kernel_head_dim(d_true)
    q, k, v, o, do = (_pad_head_dim(t, width) for t in (q, k, v, o, do))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq = torch.empty_like(q)
    m, l, dcol = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    seed, thresh, mscale = drop
    _build.launch(_NAME, _SIGNATURES, "attention_bwd_dq", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), *_seg_ptrs(segment_ids), seed, dq.data_ptr(),
                  m.data_ptr(), l.data_ptr(), dcol.data_ptr(), b, h, sq, sk,
                  d, float(sm_scale), int(bool(causal)), thresh, mscale,
                  _build.DTYPE_CODES[q.dtype])
    return _slice_head_dim(dq, d_true), m, l, dcol


def _dkv(q, k, v, do, m, l, dcol, causal, sm_scale, segment_ids, drop):
    _check(q, k, v, segment_ids)
    _check_like("do", do, q)
    check_aligned("attention_bwd", q=q, k=k, v=v, do=do)
    d_true = q.shape[-1]
    width = _kernel_head_dim(d_true)
    q, k, v, do = (_pad_head_dim(t, width) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("m", m), ("l", l), ("dcol", dcol)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()):
            raise ValueError(f"attention_bwd: {name} must be a contiguous "
                             f"fp32 [{b}, {h}, {sq}] tensor on {q.device}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    seed, thresh, mscale = drop
    _build.launch(_NAME, _SIGNATURES, "attention_bwd_dkv", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  *_seg_ptrs(segment_ids), m.data_ptr(), l.data_ptr(),
                  dcol.data_ptr(), seed, dk.data_ptr(), dv.data_ptr(), b, h,
                  sq, sk, d, float(sm_scale), int(bool(causal)), thresh,
                  mscale, _build.DTYPE_CODES[q.dtype])
    return _slice_head_dim(dk, d_true), _slice_head_dim(dv, d_true)


def attention_bwd_dq(q, k, v, o, do, *, causal, sm_scale, segment_ids=None):
    """K5: ``(dq, m, l, d)`` — dq in q's dtype and the fp32 ``[b, h, sq]``
    row statistics (max, sum of exponentials, rowsum(dO * O)) K6 reads."""
    out = _dq(q, k, v, o, do, causal, sm_scale, segment_ids, NO_DROPOUT)
    attention_bwd_dq.launches += 1
    return out


def attention_bwd_dkv(q, k, v, do, m, l, dcol, *, causal, sm_scale,
                      segment_ids=None):
    """K6: ``(dk, dv)`` in k's dtype, from K5's row statistics."""
    out = _dkv(q, k, v, do, m, l, dcol, causal, sm_scale, segment_ids,
               NO_DROPOUT)
    attention_bwd_dkv.launches += 1
    return out


def attention_bwd(q, k, v, o, do, *, causal, sm_scale, segment_ids=None):
    """K5 then K6: ``(dq, dk, dv)``."""
    dq, m, l, dcol = attention_bwd_dq(q, k, v, o, do, causal=causal,
                                      sm_scale=sm_scale,
                                      segment_ids=segment_ids)
    dk, dv = attention_bwd_dkv(q, k, v, do, m, l, dcol, causal=causal,
                               sm_scale=sm_scale, segment_ids=segment_ids)
    return dq, dk, dv


def attention_bwd_dq_dropout(q, k, v, o, do, *, causal, sm_scale, dropout_p,
                             dropout_seed, segment_ids=None):
    """K5d: K5 with the forward's dropout mask replayed on dP."""
    drop = dropout_args(dropout_p, dropout_seed, q.device)
    out = _dq(q, k, v, o, do, causal, sm_scale, segment_ids, drop)
    attention_bwd_dq_dropout.launches += 1
    return out


def attention_bwd_dkv_dropout(q, k, v, do, m, l, dcol, *, causal, sm_scale,
                              dropout_p, dropout_seed, segment_ids=None):
    """K6d: K6 with the forward's dropout mask replayed on P (for dv) and
    on dP (for dk)."""
    drop = dropout_args(dropout_p, dropout_seed, q.device)
    out = _dkv(q, k, v, do, m, l, dcol, causal, sm_scale, segment_ids, drop)
    attention_bwd_dkv_dropout.launches += 1
    return out


def attention_bwd_dropout(q, k, v, o, do, *, causal, sm_scale, dropout_p,
                          dropout_seed, segment_ids=None):
    """K5d then K6d: ``(dq, dk, dv)`` of attention with dropout."""
    kw = dict(causal=causal, sm_scale=sm_scale, dropout_p=dropout_p,
              dropout_seed=dropout_seed, segment_ids=segment_ids)
    dq, m, l, dcol = attention_bwd_dq_dropout(q, k, v, o, do, **kw)
    dk, dv = attention_bwd_dkv_dropout(q, k, v, do, m, l, dcol, **kw)
    return dq, dk, dv


attention_bwd_dq.launches = 0
attention_bwd_dkv.launches = 0
attention_bwd_dq_dropout.launches = 0
attention_bwd_dkv_dropout.launches = 0
