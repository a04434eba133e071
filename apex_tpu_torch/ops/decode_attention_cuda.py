"""Wrapper of the hand-written CUDA paged decode attention kernel
(``csrc/decode_attention.cu``; it replaces
``apex_tpu/ops/decode_attention_pallas.py:142 _kernel``). The source's
header says what bounds the kernel and how its design answers that.

:func:`decode_attention` checks its inputs, allocates the output,
launches on PyTorch's current stream without synchronising, raises on a
refused launch, and counts the launch in ``decode_attention.launches``
(a plain int; a caller resets it to 0 before the run it wants to read).
The plain version is
:func:`apex_tpu_torch.ops.decode_attention.decode_attention_reference`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "decode_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_attention_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, ctypes.c_float, _I, _I, _P], _I),
    "decode_attention_error_string": ([_I], ctypes.c_char_p),
}


def _check(q, k_pages, v_pages, page_table, lengths):
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes q {q.dtype} k "
                         f"{k_pages.dtype} v {v_pages.dtype} (want one of "
                         f"bf16/fp16/fp32 for all three)")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("decode_attention: q must be [b, h, d] and the "
                         "pages [h, P, ps, d]")
    b, h, d = q.shape
    if k_pages.shape[0] != h or k_pages.shape[3] != d \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"disagree")
    if d not in (64, 128):
        raise ValueError(f"decode_attention: head_dim {d} (the kernel "
                         f"takes 64 or 128)")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"decode_attention: page_table must be int32 "
                         f"[{b}, max_pages]")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"decode_attention: lengths must be int32 [{b}]")


def decode_attention(q, k_pages, v_pages, page_table, lengths, *, sm_scale):
    """The kernel on CUDA tensors (see the module docstring); returns a
    new ``[b, h, d]`` tensor."""
    _check(q, k_pages, v_pages, page_table, lengths)
    lib = _build.load(_NAME, _SIGNATURES)
    b, h, d = q.shape
    n_pages, ps = k_pages.shape[1], k_pages.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, n_pages, ps, page_table.shape[1], d, float(sm_scale),
            _build.DTYPE_CODES[q.dtype], q.device.index, stream)
    _build.check(lib, _NAME, rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
