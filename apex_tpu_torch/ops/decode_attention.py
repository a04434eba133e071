"""Decode attention over a paged KV cache, q_len = 1 (counterpart of
``apex_tpu/ops/decode_attention_pallas.py``).

:func:`decode_attention` is the one call: for CUDA tensors it launches
the hand-written kernel (``csrc/decode_attention.cu`` through
:mod:`apex_tpu_torch.ops.decode_attention_cuda`); for CPU tensors it runs
:func:`decode_attention_reference`, the plain version, op for op with the
JAX package's. The JAX family's impl/tile dispatch (``set_decode_impl``,
``block_h``, the dispatch table) has no counterpart here.

Layouts:
  q                [b, h, d]          (one query row per sequence slot)
  k_pages/v_pages  [h, pages, page_size, d]
  page_table       [b, max_pages]     int32 (padding -> null page 0)
  lengths          [b]                int32 (0 = inactive slot -> 0 out)

The int8 KV tier (pages of int8 codes with per-(page, head) scales) is
not ported yet: int8 pages raise.
"""

import math

import torch

NEG_INF = -1e30


def decode_attention_reference(q, k_pages, v_pages, page_table, lengths,
                               sm_scale):
    """Gather each slot's pages, mask positions at or past the length,
    exact fp32 softmax; inactive slots (length 0) give 0."""
    b, h, d = q.shape
    # [h, b, max_pages, ps, d] -> [b, h, S, d]
    k = k_pages[:, page_table].permute(1, 0, 2, 3, 4).reshape(
        b, h, -1, d).float()
    v = v_pages[:, page_table].permute(1, 0, 2, 3, 4).reshape(
        b, h, -1, d).float()
    s = ((q.float() * sm_scale)[:, :, None, :] * k).sum(dim=-1)  # [b, h, S]
    col = torch.arange(s.shape[-1], dtype=torch.int32, device=q.device)
    masked = col[None, None, :] >= lengths.to(torch.int32)[:, None, None]
    s = torch.where(masked, NEG_INF, s)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    e = torch.where(masked, 0.0, e)
    tot = e.sum(dim=-1, keepdim=True)
    p = torch.where(tot > 0, e / torch.where(tot > 0, tot, 1.0), 0.0)
    return (p[..., None] * v).sum(dim=2).to(q.dtype)


def decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                     sm_scale=None):
    """Paged decode attention (layouts in the module docstring)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8:
        raise ValueError("decode_attention: int8 KV pages (the int8 KV "
                         "tier) are not ported yet")
    if q.is_cuda:
        from apex_tpu_torch.ops import decode_attention_cuda

        return decode_attention_cuda.decode_attention(
            q, k_pages, v_pages, page_table, lengths, sm_scale=sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return decode_attention_reference(q, k_pages, v_pages, page_table,
                                      lengths, sm_scale)
