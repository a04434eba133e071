"""Wrappers of the hand-written CUDA paged decode attention kernels
(``csrc/decode_attention.cu``; they replace
``apex_tpu/ops/decode_attention_pallas.py:142 _kernel``): K2,
:func:`decode_attention`, over pages in q's dtype, and K2q,
:func:`decode_attention_quant`, the kernel's ``QUANT`` instantiation over
the int8 KV tier's pages (codes plus per-(page, head) bf16 scales, the
branch at ``:163-168``). The source's header says what bounds the kernels
and how their design answers that: a split-KV grid, each block one range
of a page's keys (:func:`plan`) writing an fp32 partial, and the last
block of each slot-head (found through an integer ticket) folding the
partials in a fixed order, all in one launch. Any head dim up to 512
(``MAX_HEAD_DIM``, the JAX kernel's ``supported`` limit) runs without
padding the cache.

Each wrapper checks its inputs, allocates the output and the partials'
scratch, launches on PyTorch's current stream without synchronising,
raises on a refused launch, and counts the call in ``<wrapper>.launches``
(a plain int; a caller resets it to 0 before the run it wants to read).
The plain version of both is
:func:`apex_tpu_torch.ops.decode_attention.decode_attention_reference`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "decode_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "decode_attention_fwd": ([_P] * 8 + [_I] * 7 + [_F, _I, _I, _I, _P],
                             _I),
    "decode_attention_quant_fwd": ([_P] * 10 + [_I] * 7
                                   + [_F, _I, _I, _I, _P], _I),
    "decode_attention_error_string": ([_I], ctypes.c_char_p),
}
# the head dims the kernels are built for (a runtime head dim runs at the
# smallest bucket that holds it) and the largest
HEAD_DIM_BUCKETS = (64, 128, 256, 512)
MAX_HEAD_DIM = HEAD_DIM_BUCKETS[-1]
# K and V of one split, at most, in shared memory (SPLIT_KV_BYTES in the
# source)
SPLIT_KV_BYTES = 64 * 1024
# (device, stream) -> int32 zeros, one a slot-head, left zero by every
# launch: the launches that share an array run in turn on their stream. A
# CUDA graph captures the array its stream has at capture, so a capture
# must find it allocated (the serving engine's warm-up call on the capture
# stream does that); every replay then finds it zero
_tickets = {}


def plan(d, page_size, max_pages, page_itemsize):
    """``(D, sk, n_splits)`` of a launch: the head-dim bucket, the keys a
    split stages (the whole page where K and V of a page fit
    ``SPLIT_KV_BYTES`` at the bucket's width, else the most that do, a
    multiple of 16), and the splits of a slot (``max_pages`` pages of
    ``ceil(page_size / sk)`` splits)."""
    D = next(w for w in HEAD_DIM_BUCKETS if d <= w)
    cap = SPLIT_KV_BYTES // (2 * D * page_itemsize)
    sk = page_size if page_size <= cap else cap // 16 * 16
    return D, sk, max_pages * -(-page_size // sk)


def _ticket_array(device, n):
    """The ticket array of PyTorch's current stream on ``device``, at
    least ``n`` long."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(n, dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _check(q, k_pages, v_pages, page_table, lengths, *scales):
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths),
                    *zip(("k_scale", "v_scale"), scales)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    page_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(f"decode_attention: dtypes q {q.dtype} k "
                         f"{k_pages.dtype} v {v_pages.dtype} (want q in "
                         f"bf16/fp16/fp32 and pages in {page_dtype})")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("decode_attention: q must be [b, h, d] and the "
                         "pages [h, P, ps, d]")
    b, h, d = q.shape
    if k_pages.shape[0] != h or k_pages.shape[3] != d \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"disagree")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {d} (the kernels "
                         f"take up to {MAX_HEAD_DIM})")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"decode_attention: page_table must be int32 "
                         f"[{b}, max_pages]")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"decode_attention: lengths must be int32 [{b}]")
    want = (h, k_pages.shape[1])
    for name, t in zip(("k_scale", "v_scale"), scales):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != want:
            raise ValueError(f"decode_attention: {name} must be bf16 "
                             f"{list(want)}, got {t.dtype} "
                             f"{list(t.shape)}")


def _launch(fn_name, q, k_pages, v_pages, scales, page_table, lengths,
            sm_scale):
    b, h, d = q.shape
    n_pages, ps = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    elem = k_pages.element_size()
    D, sk, n_splits = plan(d, ps, max_pages, elem)
    out = torch.empty_like(q)
    part = torch.empty(b * h * n_splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    tickets = _ticket_array(q.device, b * h)
    # the bulk copies move 16-byte multiples from 16-byte aligned pages
    bulk = (ps * d * elem % 16 == 0 and k_pages.data_ptr() % 16 == 0
            and v_pages.data_ptr() % 16 == 0)
    _build.launch(_NAME, _SIGNATURES, fn_name, q.device,
                  q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  *(t.data_ptr() for t in scales), page_table.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                  tickets.data_ptr(), b, h, n_pages, ps, max_pages, d, sk,
                  float(sm_scale), int(bulk), _build.DTYPE_CODES[q.dtype])
    return out


def decode_attention(q, k_pages, v_pages, page_table, lengths, *, sm_scale):
    """The kernel on CUDA tensors (see the module docstring); returns a
    new ``[b, h, d]`` tensor."""
    _check(q, k_pages, v_pages, page_table, lengths)
    out = _launch("decode_attention_fwd", q, k_pages, v_pages, (),
                  page_table, lengths, sm_scale)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_quant(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           lengths, *, sm_scale):
    """K2q on CUDA tensors: int8 ``k_pages``/``v_pages`` with their
    ``[h, pages]`` bf16 ``k_scale``/``v_scale``; returns a new ``[b, h,
    d]`` tensor in q's dtype."""
    _check(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    out = _launch("decode_attention_quant_fwd", q, k_pages, v_pages,
                  (k_scale, v_scale), page_table, lengths, sm_scale)
    decode_attention_quant.launches += 1
    return out


decode_attention_quant.launches = 0
