"""Fused attention with causal and segment-id masking (counterpart of
``apex_tpu/ops/attention.py``, and of the rows kernel's split backward in
``apex_tpu/ops/attention_pallas.py``).

:func:`fused_attention` is the one call, differentiable in q, k and v:

* forward: for CUDA tensors the hand-written prefill kernel K1
  (``csrc/prefill_attention.cu`` through
  :mod:`apex_tpu_torch.ops.attention_cuda`); for CPU tensors
  :func:`_dense_attention`, the plain version, op for op with the JAX
  package's ``_dense_attention``;
* backward (``torch.autograd.Function``): for CUDA tensors K5 and K6
  (``csrc/attention_bwd.cu`` through
  :mod:`apex_tpu_torch.ops.attention_bwd_cuda`), the split structure of
  ``attention_pallas.py:850 _bwd_split``; for CPU tensors
  :func:`_attention_bwd_split`, its plain version.

There is no fallback from one to the other. A call whose inputs need no
gradient (serving) runs the forward alone and saves nothing. The TPU
dispatch machinery (impl tables, ``set_default_impl``, the rows/flash
choice, the monolithic backward) has no counterpart here.

Layout: ``[batch, heads, seq, head_dim]``, as in the JAX package.
"""

import math

import torch


def _dense_attention(q, k, v, causal, sm_scale, segment_ids):
    """Reference semantics: fp32 scores and softmax, masked positions
    excluded, fully masked rows give 0; the probabilities are cast to
    ``v``'s dtype before the value product, which accumulates in fp32."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = _masked(q, k, causal, segment_ids)
    if mask is not None:
        scores = torch.where(mask, torch.finfo(torch.float32).min, scores)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, 0.0, e)
    s = e.sum(dim=-1, keepdim=True)
    probs = torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 0.0)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _masked(q, k, causal, segment_ids):
    """The ``[b, h, sq, sk]`` boolean mask of ``_dense_attention`` (True =
    excluded), or None."""
    b, h, sq = q.shape[:3]
    sk = k.shape[2]
    mask = None
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                > torch.arange(sq, device=q.device)[:, None])
        mask = mask.expand(b, h, sq, sk)
    if segment_ids is not None:
        seg_q, seg_kv = segment_ids
        diff = (seg_q[:, None, :, None] != seg_kv[:, None, None, :])
        diff = diff.expand(b, h, sq, sk)
        mask = diff if mask is None else (mask | diff)
    return mask


def _attention_bwd_split(q, k, v, o, do, causal, sm_scale, segment_ids):
    """``(dq, dk, dv)`` op for op with the TPU split backward
    (``_bwd_dq_kernel :435`` and ``_bwd_dkv_kernel :532``): the row
    statistics of ``_softmax_stats :136`` (max of the live scores, finfo.min
    for a fully masked row; sum of exponentials), P rebuilt as in
    ``_p_from_stats :156`` (``exp(min(s - m, 0))``, masked entries and
    rows with sum 0 give 0), ``dS = P (dP - D) scale`` rounded to the input
    dtype, P rounded to it for dv, every product accumulated in fp32, dq
    in q's dtype and dk/dv cast from fp32 at the end. D is ``rowsum(dO *
    O)`` from the forward output, as the kernel takes it (the TPU kernel
    forms ``rowsum(P * dP)``; they agree in exact arithmetic)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    mask = _masked(q, k, causal, segment_ids)
    live = s if mask is None else torch.where(
        mask, torch.finfo(torch.float32).min, s)
    m = live.amax(dim=-1, keepdim=True)
    e = torch.exp(live - m)
    if mask is not None:
        e = torch.where(mask, 0.0, e)
    tot = e.sum(dim=-1, keepdim=True)
    e = torch.exp(torch.clamp(s - m, max=0.0))
    if mask is not None:
        e = torch.where(mask, 0.0, e)
    p = torch.where(tot > 0, e / torch.where(tot > 0, tot, 1.0), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    dcol = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dcol) * sm_scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
    return dq, dk, dv.to(v.dtype)


def _attention_fwd(q, k, v, causal, sm_scale, segment_ids):
    if q.is_cuda:
        from apex_tpu_torch.ops import attention_cuda

        return attention_cuda.prefill_attention(
            q, k, v, causal=causal, sm_scale=sm_scale,
            segment_ids=segment_ids)
    if q.device.type != "cpu":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    return _dense_attention(q, k, v, causal, sm_scale, segment_ids)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, seg_q, seg_kv):
        segs = None if seg_q is None else (seg_q, seg_kv)
        o = _attention_fwd(q, k, v, causal, sm_scale, segs)
        ctx.save_for_backward(q, k, v, o, seg_q, seg_kv)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, seg_q, seg_kv = ctx.saved_tensors
        segs = None if seg_q is None else (seg_q, seg_kv)
        do = do.contiguous()
        if q.is_cuda:
            from apex_tpu_torch.ops import attention_bwd_cuda

            dq, dk, dv = attention_bwd_cuda.attention_bwd(
                q, k, v, o, do, causal=ctx.causal, sm_scale=ctx.sm_scale,
                segment_ids=segs)
        else:
            dq, dk, dv = _attention_bwd_split(q, k, v, o, do, ctx.causal,
                                              ctx.sm_scale, segs)
        return dq, dk, dv, None, None, None, None


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
        return _FusedAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                     seg_q, seg_kv)
    return _attention_fwd(q, k, v, causal, sm_scale, segment_ids)
