"""Decode attention over a paged KV cache, q_len = 1 (counterpart of
``apex_tpu/ops/decode_attention_pallas.py``).

:func:`decode_attention` is the one call: for CUDA tensors it launches
a hand-written kernel (``csrc/decode_attention.cu`` through
:mod:`apex_tpu_torch.ops.decode_attention_cuda`: K2 over pages in q's
dtype, K2q over int8 pages with their scales) up to the kernels' head
dim limit (``decode_attention_cuda.MAX_HEAD_DIM``, 512), and past it
:func:`decode_scores_attention`, the scores route (K10); for CPU tensors
it runs :func:`decode_attention_reference`, the plain version, op for op
with the JAX package's. Past 512 the JAX package routes the same way: its
``decode_attention`` finds ``supported`` (``d <= 512``) false and runs its
jnp reference. The JAX family's impl/tile dispatch (``set_decode_impl``,
``block_h``, the dispatch table) has no counterpart here.

Layouts:
  q                [b, h, d]          (one query row per sequence slot)
  k_pages/v_pages  [h, pages, page_size, d]
  page_table       [b, max_pages]     int32 (padding -> null page 0)
  lengths          [b]                int32 (0 = inactive slot -> 0 out)
  k_scale/v_scale  [h, pages]         bf16 per-(page, head) scales of the
                                      int8 KV tier, or None

The int8 KV tier (``apex_tpu_torch.serving.kv_tier``): int8 pages come
with their scales, and both versions dequantize at read (each page's
rows times that page's fp32-widened scale); int8 pages without scales
raise, as in the JAX package.
"""

import math

import torch

from apex_tpu_torch.ops.softmax import scaled_masked_softmax

NEG_INF = -1e30


def decode_attention_reference(q, k_pages, v_pages, page_table, lengths,
                               sm_scale, k_scale=None, v_scale=None):
    """Gather each slot's pages, mask positions at or past the length,
    exact fp32 softmax; inactive slots (length 0) give 0. ``k_scale``/
    ``v_scale`` (the int8 tier) gather through the same page table and
    dequantize at read."""
    b, h, d = q.shape
    ps = k_pages.shape[2]
    # [h, b, max_pages, ps, d] -> [b, h, S, d]
    k = k_pages[:, page_table].permute(1, 0, 2, 3, 4).reshape(
        b, h, -1, d).float()
    v = v_pages[:, page_table].permute(1, 0, 2, 3, 4).reshape(
        b, h, -1, d).float()
    if k_scale is not None:
        # [h, b, max_pages] -> [b, h, S]: one scale per page, repeated
        # over the page's positions
        ks = torch.repeat_interleave(
            k_scale[:, page_table].permute(1, 0, 2).float(), ps, dim=-1)
        vs = torch.repeat_interleave(
            v_scale[:, page_table].permute(1, 0, 2).float(), ps, dim=-1)
        k = k * ks[..., None]
        v = v * vs[..., None]
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


def decode_scores_attention(q, k_pages, v_pages, page_table, lengths,
                            sm_scale, k_scale=None, v_scale=None):
    """The scores route of decode, the counterpart of JAX's
    ``decode_attention_reference`` where its kernel stops (``d > 512``):
    gather each slot's pages by the page table (int8 pages dequantized by
    the tier's codec with their gathered scales), fp32 scores from
    ``torch.matmul``, the softmax of ``sm_scale`` times them with the
    positions at or past each slot's length masked by a ``[b, 1, 1, S]``
    key-padding mask (K10 on the card, read at stride 0 over heads and
    the query; a slot of length 0 gives 0), and the fp32 context from
    ``torch.matmul``, cast to q's dtype."""
    b, h, d = q.shape

    def gathered(pages, scale):
        # [h, b, max_pages, ps, d] -> [b, h, S, d]
        g = pages[:, page_table]
        if scale is None:
            g = g.float()
        else:
            from apex_tpu_torch.serving import kv_tier

            g = kv_tier.dequantize(g, scale[:, page_table])
        return g.permute(1, 0, 2, 3, 4).reshape(b, h, -1, d)

    k = gathered(k_pages, k_scale)
    v = gathered(v_pages, v_scale)
    scores = torch.matmul(q.float()[:, :, None, :], k.transpose(-1, -2))
    col = torch.arange(scores.shape[-1], device=q.device)
    mask = col[None, :] >= lengths.to(torch.int64)[:, None]
    probs = scaled_masked_softmax(scores, mask[:, None, None, :], sm_scale)
    return torch.matmul(probs, v)[:, :, 0].to(q.dtype)


def decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                     sm_scale=None, k_scale=None, v_scale=None):
    """Paged decode attention (layouts in the module docstring); with
    ``k_scale``/``v_scale`` the pages are the int8 tier's codes. On the
    card past ``MAX_HEAD_DIM`` the scores route
    (:func:`decode_scores_attention`)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: k_scale and v_scale come as a "
                         "pair (one of them is missing)")
    if k_scale is None and (k_pages.dtype == torch.int8
                            or v_pages.dtype == torch.int8):
        raise ValueError("decode_attention: int8 pages without k_scale/"
                         "v_scale — quantized codes are meaningless "
                         "without their scales")
    if q.is_cuda:
        from apex_tpu_torch.ops import decode_attention_cuda

        if q.shape[-1] > decode_attention_cuda.MAX_HEAD_DIM:
            return decode_scores_attention(q, k_pages, v_pages, page_table,
                                           lengths, sm_scale, k_scale,
                                           v_scale)
        if k_scale is not None:
            return decode_attention_cuda.decode_attention_quant(
                q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                sm_scale=sm_scale)
        return decode_attention_cuda.decode_attention(
            q, k_pages, v_pages, page_table, lengths, sm_scale=sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return decode_attention_reference(q, k_pages, v_pages, page_table,
                                      lengths, sm_scale, k_scale, v_scale)
