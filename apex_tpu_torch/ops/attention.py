"""Fused attention with causal and segment-id masking (counterpart of
``apex_tpu/ops/attention.py``).

:func:`fused_attention` is the one call: for CUDA tensors it launches the
hand-written prefill kernel (``csrc/prefill_attention.cu`` through
:mod:`apex_tpu_torch.ops.attention_cuda`); for CPU tensors it runs
:func:`_dense_attention`, the plain version, op for op with the JAX
package's ``_dense_attention``. There is no fallback from one to the
other. The TPU dispatch machinery (impl tables, ``set_default_impl``,
the rows/flash choice) has no counterpart here.

Layout: ``[batch, heads, seq, head_dim]``, as in the JAX package.
"""

import math

import torch


def _dense_attention(q, k, v, causal, sm_scale, segment_ids):
    """Reference semantics: fp32 scores and softmax, masked positions
    excluded, fully masked rows give 0; the probabilities are cast to
    ``v``'s dtype before the value product, which accumulates in fp32."""
    sq, sk = q.shape[2], k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = None
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                > torch.arange(sq, device=q.device)[:, None])
        mask = mask.expand(scores.shape)
    if segment_ids is not None:
        seg_q, seg_kv = segment_ids
        diff = (seg_q[:, None, :, None] != seg_kv[:, None, None, :])
        diff = diff.expand(scores.shape)
        mask = diff if mask is None else (mask | diff)
    if mask is not None:
        scores = torch.where(mask, torch.finfo(torch.float32).min, scores)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, 0.0, e)
    s = e.sum(dim=-1, keepdim=True)
    probs = torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 0.0)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_attention(q, k, v, *, causal=False, sm_scale=None,
                    segment_ids=None):
    """Attention over ``[b, h, s, d]`` tensors.

    Args:
      q, k, v: ``[b, h, sq|sk, d]``, one device and dtype.
      causal: apply the lower-triangular mask (key index > query index
        is masked).
      sm_scale: softmax scale; default ``1/sqrt(d)``.
      segment_ids: optional ``(seg_q [b, sq], seg_kv [b, sk])`` int
        tensors — tokens attend only within equal ids (packed batches).
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        from apex_tpu_torch.ops import attention_cuda

        return attention_cuda.prefill_attention(
            q, k, v, causal=causal, sm_scale=sm_scale,
            segment_ids=segment_ids)
    if q.device.type != "cpu":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    return _dense_attention(q, k, v, causal, sm_scale, segment_ids)
