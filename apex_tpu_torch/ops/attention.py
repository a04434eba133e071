"""Fused attention with causal and segment-id masking and in-kernel
attention dropout (counterpart of ``apex_tpu/ops/attention.py``, and of
the rows kernel ``fused_attention_rows`` in
``apex_tpu/ops/attention_pallas.py``: its forward, its split backward and
the dropout replay of its monolithic backward).

:func:`fused_attention` is the one call, differentiable in q, k and v:

* forward: for CUDA tensors the hand-written prefill kernel K1
  (``csrc/prefill_attention.cu`` through
  :mod:`apex_tpu_torch.ops.attention_cuda`), or its dropout variant K1d
  when ``dropout_p > 0``; for CPU tensors :func:`_dense_attention`, the
  plain version, op for op with the JAX package's ``_dense_attention``
  and, with dropout, with the rows kernel's ``_fwd_kernel :230``;
* backward (``torch.autograd.Function``): for CUDA tensors K5 and K6
  (``csrc/attention_bwd.cu`` through
  :mod:`apex_tpu_torch.ops.attention_bwd_cuda`), the split structure of
  ``attention_pallas.py:850 _bwd_split``, or their dropout variants K5d
  and K6d, which replay the forward's mask as the monolithic backward
  ``_bwd_kernel :303`` does (``:331-346``); for CPU tensors
  :func:`_attention_bwd_split`, their plain version.

Dropout is inverted dropout on the normalized probabilities. Its mask is
never stored: :func:`dropout_mscale` is a chained ``fmix32`` hash of the
seed and the global (batch, head, row, column) of each score, bit for bit
the JAX package's ``_dropout_mscale :198``, so any tiling and any walk
order (the backward's k-major dk/dv pass) regenerates the same bits.

There is no fallback from one to the other. A call whose inputs need no
gradient (serving) runs the forward alone and saves nothing. The TPU
dispatch machinery (impl tables, ``set_default_impl``, the rows/flash
choice, the monolithic backward) has no counterpart here.

The route is chosen by head dim alone, in :func:`kernel_route`, where
the JAX package chooses it (``apex_tpu/ops/attention.py:186-201``: the
rows kernel only where ``attention_pallas.supported`` holds, d <= 256):

* up to 256, the kernels above. They are built for head dims 64, 128 and
  256 (``KERNEL_HEAD_DIMS``); on the card any other head dim is
  zero-padded to the next of them by :func:`_pad_head_dim`, and the
  results are sliced back. The pad is exact: zero columns of q and k add
  nothing to a score, zero columns of v give zero output columns, the
  padded columns of dq, dk and dv are zero, and the scale is always
  passed in from the true head dim. The autograd path pads once in the
  forward and saves the padded q, k, v and o, so that the backward pads
  only dO;
* past 256, the scores route :func:`_scores_attention`, what JAX's
  ``_dense_attention :25`` computes: fp32 scores from ``torch.matmul``,
  the softmax by the fused softmax kernel (K10, and K11 in the
  backward, through :func:`apex_tpu_torch.ops.softmax.
  scaled_masked_softmax`), the probabilities in v's dtype, the context
  by ``torch.matmul``; autograd differentiates it. JAX computes those
  products outside any Pallas kernel too. In-kernel dropout stops at
  256, as JAX's does (``supported(..., dropout=True)``); the training
  model takes the scores path there.

Layout: ``[batch, heads, seq, head_dim]``, as in the JAX package.
"""

import math
import struct

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.softmax import scaled_masked_softmax

_U32 = 0xFFFFFFFF

# the head dims the attention kernels are built for; the largest is the
# limit of the rows kernel the JAX package runs (d <= 256)
KERNEL_HEAD_DIMS = (64, 128, 256)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]


def kernel_route(d):
    """The route of attention at head dim ``d``: ``"kernels"`` (K1/K1d
    forward, K5/K6 or K5d/K6d backward) up to ``MAX_HEAD_DIM``, else
    ``"scores"`` (:func:`_scores_attention`), as the JAX package routes
    past its rows kernel's limit."""
    return "kernels" if d <= MAX_HEAD_DIM else "scores"


def _kernel_head_dim(d):
    """The kernel head dim a head dim of ``d`` runs at: the smallest of
    ``KERNEL_HEAD_DIMS`` at least ``d``. Raises past ``MAX_HEAD_DIM``."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"fused_attention: head_dim {d} (the kernels take up "
                     f"to {MAX_HEAD_DIM})")


def _pad_head_dim(t, width):
    """``t [..., d]`` zero-padded on its last axis to ``width`` (``t``
    itself where ``d == width``)."""
    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))


def _slice_head_dim(t, d):
    """The first ``d`` columns of a padded result, contiguous (``t``
    itself where nothing was padded)."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _mul32(x, c):
    """``x * c mod 2**32`` for int64 tensors holding uint32 values: the
    product is split at 16 bits of ``c`` so that no int64 term overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _fmix32(x):
    """murmur3's 32-bit finalizer (``attention_pallas.py:188 _fmix32``) on
    int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_threshold(p):
    """The uint32 keep threshold of ``_dropout_mscale :225``: ``p * 2**32``
    in double, truncated (p = 0.1 gives 429496729); a score is kept where
    its hash is at least this."""
    return int(min(max(p, 0.0), 1.0) * 4294967296.0)


def dropout_scale(p):
    """The survivors' scale ``float32(1 / (1 - p))``, rounded once from
    double."""
    return struct.unpack("f", struct.pack("f", 1.0 / (1.0 - p)))[0]


def dropout_mscale(seed, b, h, sq, sk, p, row0=0, col0=0):
    """fp32 ``[b, h, sq, sk]`` inverted-dropout scale (``1/(1-p)`` where
    kept, 0 where dropped) of the scores whose global rows start at
    ``row0`` and columns at ``col0``: bit for bit
    ``attention_pallas.py:198 _dropout_mscale`` for every (b, h). ``seed``
    is an int32 ``[1]`` tensor (its two's-complement bits are the uint32
    seed); the mask lies on its device. The chain: ``s = fmix32(0x9E3779B9
    ^ seed)``, ``s_bh = fmix32(s ^ (b * H + h))``, ``rowkey = fmix32(s_bh ^
    row)``, ``bits = fmix32(rowkey ^ col)``, kept where ``bits >=
    dropout_threshold(p)``. uint32 arithmetic runs in int64 masked to 32
    bits."""
    dev = seed.device
    s = _fmix32(0x9E3779B9 ^ (seed.reshape(()).to(torch.int64) & _U32))
    bh = (torch.arange(b, device=dev)[:, None] * h
          + torch.arange(h, device=dev)[None, :]) & _U32
    s_bh = _fmix32(s ^ bh)[:, :, None, None]
    row = (row0 + torch.arange(sq, device=dev)) & _U32
    col = (col0 + torch.arange(sk, device=dev)) & _U32
    rowkey = _fmix32(s_bh ^ row[:, None])              # [b, h, sq, 1]
    keep = _fmix32(rowkey ^ col) >= dropout_threshold(p)
    return torch.where(keep, dropout_scale(p), 0.0)


def _softmax_probs(q, k, causal, sm_scale, segment_ids):
    """fp32 P of ``_dense_attention``: masked positions excluded, fully
    masked rows give 0."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = _masked(q, k, causal, segment_ids)
    if mask is not None:
        scores = torch.where(mask, torch.finfo(torch.float32).min, scores)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, 0.0, e)
    s = e.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 0.0)


def _dense_attention(q, k, v, causal, sm_scale, segment_ids, dropout_p=0.0,
                     dropout_seed=None):
    """Reference semantics: fp32 scores and softmax, masked positions
    excluded, fully masked rows give 0; with ``dropout_p > 0`` the
    normalized probabilities are multiplied by :func:`dropout_mscale`
    (``_fwd_kernel :251-258``); the probabilities are cast to ``v``'s
    dtype before the value product, which accumulates in fp32."""
    probs = _softmax_probs(q, k, causal, sm_scale, segment_ids)
    if dropout_p > 0.0:
        b, h, sq, sk = probs.shape
        probs = probs * dropout_mscale(dropout_seed, b, h, sq, sk, dropout_p)
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


def _attention_bwd_split(q, k, v, o, do, causal, sm_scale, segment_ids,
                         dropout_p=0.0, dropout_seed=None):
    """``(dq, dk, dv)`` op for op with the TPU split backward
    (``_bwd_dq_kernel :435`` and ``_bwd_dkv_kernel :532``): the row
    statistics of ``_softmax_stats :136`` (max of the live scores, finfo.min
    for a fully masked row; sum of exponentials), P rebuilt as in
    ``_p_from_stats :156`` (``exp(min(s - m, 0))``, masked entries and
    rows with sum 0 give 0), ``dS = P (dP - D) scale`` rounded to the input
    dtype, P rounded to it for dv, every product accumulated in fp32, dq
    in q's dtype and dk/dv cast from fp32 at the end. D is ``rowsum(dO *
    O)`` from the forward output, as the kernel takes it (the TPU kernel
    forms ``rowsum(P * dP)``; they agree in exact arithmetic).

    With ``dropout_p > 0`` it computes the function of the monolithic
    backward's dropout replay (``_bwd_kernel :331-346``) with the mask of
    :func:`dropout_mscale`: dv from ``P * mscale`` rounded to the input
    dtype, ``dS = P (dP mscale - D) scale``. D stays ``rowsum(dO * O)``:
    the TPU kernel's ``rowsum(P mscale * dP)`` is the same in exact
    arithmetic, because ``O = (P mscale) V``."""
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
    p_lo = p
    if dropout_p > 0.0:
        b, h, sq, sk = p.shape
        mscale = dropout_mscale(dropout_seed, b, h, sq, sk, dropout_p)
        p_lo = p * mscale
        dp = dp * mscale
    ds = (p * (dp - dcol) * sm_scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p_lo.to(q.dtype).float().transpose(-1, -2), dof)
    return dq, dk, dv.to(v.dtype)


def _scores_attention(q, k, v, causal, sm_scale, segment_ids):
    """The scores route: JAX's ``_dense_attention :25`` with the softmax
    on the fused softmax kernel. fp32 scores ``q k^T``; the softmax of
    ``sm_scale`` times them with the causal triangle and, with segment
    ids, the ``[b, 1, sq, sk]`` mask ``seg_q != seg_kv`` (K10 broadcasts
    it over heads and never expands it) masked out, a fully masked row
    giving 0; the probabilities cast to v's dtype; the context in fp32,
    cast to q's dtype. Differentiable by autograd (K11 for the softmax)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    mask = None
    if segment_ids is not None:
        seg_q, seg_kv = segment_ids
        mask = seg_q[:, None, :, None] != seg_kv[:, None, None, :]
    probs = scaled_masked_softmax(scores, mask, sm_scale, causal)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _attention_fwd(q, k, v, causal, sm_scale, segment_ids, dropout_p,
                   dropout_seed):
    if q.is_cuda:
        from apex_tpu_torch.ops import attention_cuda

        if dropout_p > 0.0:
            return attention_cuda.prefill_attention_dropout(
                q, k, v, causal=causal, sm_scale=sm_scale,
                dropout_p=dropout_p, dropout_seed=dropout_seed,
                segment_ids=segment_ids)
        return attention_cuda.prefill_attention(
            q, k, v, causal=causal, sm_scale=sm_scale,
            segment_ids=segment_ids)
    if q.device.type != "cpu":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    return _dense_attention(q, k, v, causal, sm_scale, segment_ids,
                            dropout_p, dropout_seed)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, seg_q, seg_kv, dropout_p,
                seed):
        segs = None if seg_q is None else (seg_q, seg_kv)
        d = q.shape[-1]
        if q.is_cuda:       # padded once here; the backward reuses it
            width = _kernel_head_dim(d)
            q, k, v = (_pad_head_dim(t, width) for t in (q, k, v))
        o = _attention_fwd(q, k, v, causal, sm_scale, segs, dropout_p, seed)
        ctx.save_for_backward(q, k, v, o, seg_q, seg_kv, seed)
        ctx.causal, ctx.sm_scale, ctx.dropout_p = causal, sm_scale, dropout_p
        ctx.head_dim = d
        return _slice_head_dim(o, d)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, seg_q, seg_kv, seed = ctx.saved_tensors
        segs = None if seg_q is None else (seg_q, seg_kv)
        do = _pad_head_dim(do.contiguous(), q.shape[-1])
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale, segment_ids=segs)
        if q.is_cuda:
            from apex_tpu_torch.ops import attention_bwd_cuda

            if ctx.dropout_p > 0.0:
                dq, dk, dv = attention_bwd_cuda.attention_bwd_dropout(
                    q, k, v, o, do, dropout_p=ctx.dropout_p,
                    dropout_seed=seed, **kw)
            else:
                dq, dk, dv = attention_bwd_cuda.attention_bwd(q, k, v, o, do,
                                                              **kw)
        else:
            dq, dk, dv = _attention_bwd_split(q, k, v, o, do, ctx.causal,
                                              ctx.sm_scale, segs,
                                              ctx.dropout_p, seed)
        d = ctx.head_dim
        return (dq[..., :d], dk[..., :d], dv[..., :d], None, None, None,
                None, None, None)


def fused_attention(q, k, v, *, causal=False, sm_scale=None,
                    segment_ids=None, dropout_p=0.0, dropout_seed=None):
    """Attention over ``[b, h, s, d]`` tensors, on the route
    :func:`kernel_route` gives its head dim.

    Args:
      q, k, v: ``[b, h, sq|sk, d]``, one device and dtype.
      causal: apply the lower-triangular mask (key index > query index
        is masked).
      sm_scale: softmax scale; default ``1/sqrt(d)`` of the true head
        dim (never of a padded one).
      segment_ids: optional ``(seg_q [b, sq], seg_kv [b, sk])`` int
        tensors — tokens attend only within equal ids (packed batches).
      dropout_p: inverted dropout on the probabilities, in ``[0, 1)``;
        the counterpart of ``fused_attention_rows``'s in-kernel dropout,
        up to head dim 256 (past it the call raises).
      dropout_seed: an int32 ``[1]`` tensor on q's device, required when
        ``dropout_p > 0``. It stays on the device (the kernels read it
        through a pointer), so a step that draws it never waits on the
        host. One seed and the global (b, h, row, column) of a score
        decide its mask bit, in the forward and in the backward's replay.
    """
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p={dropout_p} outside [0, 1)")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    if dropout_p == 0.0:
        dropout_seed = None
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if kernel_route(q.shape[-1]) == "scores":
        if dropout_p > 0.0:
            raise ValueError(f"fused_attention: in-kernel dropout takes head "
                             f"dims up to {MAX_HEAD_DIM}, got "
                             f"{q.shape[-1]} (the scores path applies "
                             f"dropout past it)")
        return _scores_attention(q, k, v, causal, sm_scale, segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
        return _FusedAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                     seg_q, seg_kv, float(dropout_p),
                                     dropout_seed)
    return _attention_fwd(q, k, v, causal, sm_scale, segment_ids,
                          float(dropout_p), dropout_seed)
