"""Prefill and decode-step functions over the GPTModel parameter tree
(counterpart of ``apex_tpu/serving/model.py``, op for op).

The parameter tree is the JAX package's (``serving/weights.py``). The
numerics follow the JAX serving forward: fp32 layer-norm statistics with
the population variance, ``x @ W^T`` matmuls that accumulate in fp32 and
round to the compute dtype, biases cast to the compute dtype and added
after that rounding, the per-head ``[q|k|v]`` interleave of the fused qkv
projection, tanh-approximate GELU, and tied logits against the word
table. The embedding rows are summed in the parameter dtype (fp32) and
only then cast.

* :func:`prefill` — one packed prompt batch ``[S_pack]`` with segment
  ids: every token's K/V scattered into its request's cache pages, causal
  + segment-masked attention through :func:`fused_attention` (the
  prefill kernel on CUDA), next-token logits gathered at each request's
  last prompt token.
* :func:`decode_step` — one token per slot over the paged cache: append
  K/V at ``length-1``, attend through :func:`decode_attention` (the
  decode kernel on CUDA), greedy next token.
* :func:`decode_block` — K decode steps in one call (JAX's ``lax.scan``
  block, here a loop the engine captures as one CUDA graph), with
  per-lane step budgets, a warm-token feed and the sampling lanes.

The cache tensors are updated in place (the JAX functions return a new
cache; here the same dict is returned, already updated). On the int8 KV
tier (a cache with scale leaves, :func:`kv_tier.is_quantized`) both
scatters go through the quantize-at-write codec
(:mod:`apex_tpu_torch.serving.kv_tier`); prefill attention still runs on
the fresh K/V in the compute dtype, and decode attention reads the int8
pages with their scales (K2q on the card).

Serving constraints (:func:`check_serving_config`): no dropout, no
query-key layer scaling, no MoE, no sequence or context parallelism.
Every head dim serves: prefill past head dim 256 takes
:func:`fused_attention`'s scores route (K10 on the card), as the JAX
prefill falls back to its dense attention there, and decode past 512 (the
decode kernels' limit, the JAX kernel's ``decode_attention_pallas.
supported``) takes :func:`decode_attention`'s scores route (K10 again),
as the JAX decode falls back to its jnp reference.

Weight quantization (:func:`quantize_decode_params`, ``qparams=`` of
:func:`decode_step` and :func:`decode_block`): the decode matmuls (qkv,
dense, h->4h, 4h->h of every layer, and the logits against the word
table) run on int8 records through :func:`_wmat`, K23 on the card; the
word table keeps its float copy for the embedding gather, and prefill
keeps the full-precision weights, as in JAX.

Matmul precision: an fp32 run on the card needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) to
match the JAX numbers; ``chip_smoke.py`` sets it.
"""

import math

import torch
import torch.nn.functional as F

from apex_tpu_torch import _env
from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.ops.decode_attention import decode_attention
from apex_tpu_torch.serving import kv_tier
from apex_tpu_torch.serving import quant as quant_mod
from apex_tpu_torch.serving import sampling as sampling_mod


def check_serving_config(cfg):
    """Raise on TransformerConfig options the serving forward does not
    model."""
    problems = []
    if cfg.hidden_dropout or cfg.attention_dropout:
        problems.append("dropout > 0 (serving is deterministic)")
    if cfg.apply_query_key_layer_scaling:
        problems.append("apply_query_key_layer_scaling (training-range "
                        "trick; set False like minimal.py)")
    if cfg.num_moe_experts:
        problems.append("MoE")
    if cfg.sequence_parallel or cfg.context_parallel_axis:
        problems.append("sequence/context parallelism (single-chip "
                        "serving engine)")
    if problems:
        raise ValueError("serving does not support: "
                         + "; ".join(problems))


def compute_dtype(cfg):
    return torch.bfloat16 if cfg.bf16 else (
        torch.float16 if cfg.fp16 else torch.float32)


def _mm(x, w, dtype):
    """``x @ w^T`` in ``dtype`` with fp32 accumulation, rounded to
    ``dtype`` (the JAX ``dot_general(preferred_element_type=f32)``
    followed by a cast)."""
    if dtype == torch.float32:
        return torch.matmul(x.float(), w.float().t())
    # half-precision matmuls accumulate in fp32 and round once, on the
    # CPU and in cuBLAS alike
    return torch.matmul(x.to(dtype), w.to(dtype).t())


def _layer_norm(x, p, eps):
    """fp32-statistics layer norm (population variance, rsqrt)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["weight"].float() + p["bias"].float()
    return y.to(x.dtype)


def _split_qkv(qkv, n_heads, hd):
    """``[rows, 3*proj]`` -> (q, k, v) each ``[rows, n_heads, hd]`` with
    the per-head ``[q|k|v]`` interleave of the fused projection: reshape
    to ``[rows, heads, 3*hd]`` and split the last axis."""
    rows = qkv.shape[0]
    qkv = qkv.reshape(rows, n_heads, 3 * hd)
    return qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]


def cast_params(params, cfg):
    """A copy of the tree whose matmul weights and biases are already in
    the compute dtype, plus ``word_logits``, the word table in the compute
    dtype for the logits matmul. The embedding tables and layer-norm
    parameters keep fp32. Numerically the same as casting inside every
    call (``_mm`` casts are then no-ops); it saves the per-call casts."""
    dtype = compute_dtype(cfg)

    def cast(node, name=""):
        if isinstance(node, torch.Tensor):
            keep = name.startswith(("embedding", "word_embeddings")) \
                or "layernorm" in name
            return node if keep else node.to(dtype)
        return {k: cast(v, f"{name}/{k}" if name else k)
                for k, v in node.items()}

    out = cast(params)
    out["word_logits"] = params["word_embeddings"].to(dtype)
    return out


def quantize_decode_params(params, cfg):
    """The decode-side int8 records: each decode matmul weight becomes
    ``{"wq", "scale"}`` (int8 and per-channel fp32, from the weights as
    given, before any cast to the compute dtype); biases and norms stay
    full precision, and the word table keeps its float copy for the
    embedding gather (only the logits matmul reads ``word_logits``)."""
    qp = {"layers": [], "word_logits": None}
    for i in range(cfg.num_layers):
        lp = params["transformer"][f"layer_{i}"]
        rec = {}
        for name, sub in (("qkv", lp["self_attention"]["query_key_value"]),
                          ("dense", lp["self_attention"]["dense"]),
                          ("h4", lp["mlp"]["dense_h_to_4h"]),
                          ("4h", lp["mlp"]["dense_4h_to_h"])):
            wq, scale = quant_mod.quantize_weight(sub["weight"])
            rec[name] = {"wq": wq, "scale": scale}
        qp["layers"].append(rec)
    wq, scale = quant_mod.quantize_weight(params["word_embeddings"])
    qp["word_logits"] = {"wq": wq, "scale": scale}
    return qp


def _wmat(x, full_w, qrec, dtype):
    """One decode matmul: the int8 record when there is one (K23 on the
    card), else the full-precision weight."""
    if qrec is not None:
        return quant_mod.qmatmul(x, qrec["wq"], qrec["scale"], dtype)
    return _mm(x, full_w, dtype)


def _trunk_layer(x, lp, cfg, attn, qr=None):
    """ONE transformer layer of the serving trunk, shared by prefill and
    decode; ``attn(q, k, v)`` owns the cache write and the attention and
    returns the ``[rows, heads*head_dim]`` context. ``qr`` is the layer's
    int8 record dict (None: full precision)."""
    dtype = x.dtype
    qr = qr or {}
    ln1 = _layer_norm(x, lp["input_layernorm"], cfg.layernorm_epsilon)
    sa = lp["self_attention"]
    qkv = _wmat(ln1, sa["query_key_value"]["weight"], qr.get("qkv"), dtype) \
        + sa["query_key_value"]["bias"].to(dtype)
    q, k, v = _split_qkv(qkv, cfg.num_attention_heads, cfg.head_dim)
    ctx = attn(q, k, v)
    attn_out = _wmat(ctx, sa["dense"]["weight"], qr.get("dense"), dtype) \
        + sa["dense"]["bias"].to(dtype)
    x = x + attn_out
    ln2 = _layer_norm(x, lp["post_attention_layernorm"],
                      cfg.layernorm_epsilon)
    mlp = lp["mlp"]
    inter = _wmat(ln2, mlp["dense_h_to_4h"]["weight"], qr.get("h4"),
                  dtype) + mlp["dense_h_to_4h"]["bias"].to(dtype)
    inter = F.gelu(inter, approximate="tanh")
    out = _wmat(inter, mlp["dense_4h_to_h"]["weight"], qr.get("4h"),
                dtype) + mlp["dense_4h_to_h"]["bias"].to(dtype)
    return x + out


def _embed(params, ids, positions, dtype):
    """Word + position rows summed in the parameter dtype, then cast."""
    x = params["word_embeddings"][ids] \
        + params["embedding"]["position_embeddings"][positions]
    return x.to(dtype)


def _logits(params, x, dtype, qrec=None):
    return _wmat(x, params.get("word_logits", params["word_embeddings"]),
                 qrec, dtype)


# --------------------------------------------------------------- prefill

def prefill(params, cache, ids, positions, seg, token_rows, page_table,
            last_idx, keep_scale=None, *, cfg):
    """One packed prompt batch through the trunk, filling the cache.

    ids/positions/seg/token_rows: ``[S_pack]`` int tensors — token values,
    their within-request positions, segment ids (0 = padding, 1..R real),
    and each token's row into ``page_table`` (padding rows point at the
    all-null spare row). page_table: ``[R_rows, max_pages]`` int32.
    last_idx: ``[G]`` flat pack indices to gather logits at. Returns
    ``(cache, logits [G, vocab])``; ``cache`` is updated in place.

    keep_scale: ``[num_pages]`` fp32 (1 = the page already holds live rows
    whose scale must survive, 0 = fresh or null), required by and only
    read on the int8 KV tier.
    """
    dtype = compute_dtype(cfg)
    hd, n_heads = cfg.head_dim, cfg.num_attention_heads
    ps = cache["k"].shape[3]
    S = ids.shape[0]

    ids, positions = ids.long(), positions.long()
    x = _embed(params, ids, positions, dtype)
    rows = token_rows_to_pages(page_table, token_rows.long())
    dest_page = torch.gather(rows, 1, (positions // ps)[:, None])[:, 0].long()
    dest_off = positions % ps

    quant = kv_tier.is_quantized(cache)
    if quant and keep_scale is None:
        raise ValueError(
            "prefill on a quantized cache needs the keep_scale row — "
            "requantizing without it would zero surviving pages")

    seg2 = seg.to(torch.int32)[None, :].contiguous()
    for i in range(cfg.num_layers):
        def attn(q, k, v, i=i):
            # scatter this layer's K/V at (page, offset): the token axis of
            # the [S, H, d] values lands on the page/offset pair, heads
            # stay on the head axis (JAX's mixed basic/advanced indexing
            # puts the token axis first; torch's puts it at the index
            # position, hence the [H, S, d] view here); the int8 tier
            # routes the same scatter through the quantize-at-write codec
            if quant:
                for part, val in (("k", k), ("v", v)):
                    kv_tier.prefill_scatter_quant(cache, i, part, val,
                                                  dest_page, dest_off,
                                                  keep_scale)
            else:
                cache["k"][i][:, dest_page, dest_off] = \
                    k.to(cache["k"].dtype).transpose(0, 1)
                cache["v"][i][:, dest_page, dest_off] = \
                    v.to(cache["v"].dtype).transpose(0, 1)
            ctx = fused_attention(
                q.transpose(0, 1)[None].contiguous(),
                k.transpose(0, 1)[None].contiguous(),
                v.transpose(0, 1)[None].contiguous(), causal=True,
                sm_scale=1.0 / math.sqrt(hd), segment_ids=(seg2, seg2))
            return ctx[0].transpose(0, 1).reshape(S, n_heads * hd)

        x = _trunk_layer(x, params["transformer"][f"layer_{i}"], cfg, attn)

    x = _layer_norm(x, params["transformer"]["final_layernorm"],
                    cfg.layernorm_epsilon)
    logits = _logits(params, x[last_idx.long()], dtype)
    return cache, logits


def token_rows_to_pages(page_table, token_rows):
    """``[S, max_pages]`` per-token page-table rows."""
    return page_table[token_rows]


# ---------------------------------------------------------------- decode

def decode_step(params, cache, tokens, lengths, page_table, *, cfg,
                qparams=None):
    """One greedy decode step for every slot (q_len = 1).

    tokens/lengths: ``[B]`` int tensors — the token to process and the
    context length INCLUDING it (0 = inactive slot: its writes land on
    the null page, its logits and next token are zeros). page_table:
    ``[B, max_pages]`` int32. ``qparams`` (from
    :func:`quantize_decode_params`) switches the decode matmuls to the
    int8 records. Returns ``(cache, next_tokens [B], logits [B,
    vocab])``; ``cache`` is updated in place.
    """
    dtype = compute_dtype(cfg)
    hd, n_heads = cfg.head_dim, cfg.num_attention_heads
    ps = cache["k"].shape[3]
    B = tokens.shape[0]

    lengths = lengths.long()
    active = lengths > 0
    positions = torch.clamp(lengths - 1, min=0)
    write_page = torch.where(
        active,
        torch.gather(page_table, 1, (positions // ps)[:, None])[:, 0].long(),
        0)
    write_off = torch.where(active, positions % ps, 0)

    x = _embed(params, tokens.long(), positions, dtype)
    lengths32 = lengths.to(torch.int32).contiguous()
    ql = qparams["layers"] if qparams is not None else None
    quant = kv_tier.is_quantized(cache)
    for i in range(cfg.num_layers):
        def attn(q, k, v, i=i):
            # append this step's k/v at (page, offset): [B, H, d] values
            # as an [H, B, d] view for torch's index placement; the int8
            # tier rewrites the touched pages through the per-page
            # read-modify-write codec, and its pages reach the attention
            # with their per-(page, head) scales
            if quant:
                for part, val in (("k", k), ("v", v)):
                    kv_tier.decode_scatter_quant(cache, i, part, val,
                                                 write_page, write_off)
            else:
                cache["k"][i][:, write_page, write_off] = \
                    k.to(cache["k"].dtype).transpose(0, 1)
                cache["v"][i][:, write_page, write_off] = \
                    v.to(cache["v"].dtype).transpose(0, 1)
            ctx = decode_attention(
                q.to(dtype).contiguous(), cache["k"][i], cache["v"][i],
                page_table, lengths32, sm_scale=1.0 / math.sqrt(hd),
                k_scale=cache["k_scale"][i] if quant else None,
                v_scale=cache["v_scale"][i] if quant else None)
            return ctx.reshape(B, n_heads * hd).to(dtype)

        x = _trunk_layer(x, params["transformer"][f"layer_{i}"], cfg, attn,
                         ql[i] if ql is not None else None)

    x = _layer_norm(x, params["transformer"]["final_layernorm"],
                    cfg.layernorm_epsilon)
    logits = _logits(params, x, dtype,
                     qparams["word_logits"] if qparams is not None else None)
    next_tokens = torch.where(
        active, torch.argmax(logits.float(), dim=-1).to(torch.int32), 0)
    return cache, next_tokens, logits


# ---------------------------------------------- multi-token decode block

def resolve_decode_k(per_call=None):
    """The decode block's K: the per-call ``decode_k=`` is a demand (a
    bool, a non-int or K < 1 raises); ``APEX_SERVE_DECODE_K`` is a
    preference (garbage warns once and is ignored); default 1."""
    if per_call is not None:
        if isinstance(per_call, bool) or not isinstance(per_call, int) \
                or per_call < 1:
            raise ValueError(
                f"decode_k= wants an int >= 1, got {per_call!r}")
        return per_call
    return _env.env_int("APEX_SERVE_DECODE_K") or 1


def decode_block(params, cache, tokens, lengths, page_table, steps_budget,
                 warm_tokens, warm_steps, lanes=None, *, k, cfg,
                 qparams=None):
    """K decode steps in one call (JAX's ``decode_block``, a ``lax.scan``
    over :func:`decode_step`; here a loop with no host read, so the engine
    can capture it once as a CUDA graph). Per step ``j`` (0-based):

    * a lane is live while ``j < steps_budget[i]`` and its length is
      non-zero; a dead lane's length is masked to 0 for the step, so its
      K/V write goes to null page 0 and it emits token 0
      (:func:`decode_step`'s inactive-slot contract), and its length does
      not advance;
    * warm-up steps (``j < warm_steps[i]``) feed the next known token
      ``warm_tokens[j, i]`` as the following step's input instead of the
      emitted one;
    * sampling lanes (``lanes = (temps, top_ks, top_ps, keys, counters)``)
      draw with the counter ``counters + max(0, j - warm_steps)``, so the
      draw for generation index g is ``fold_in(key, g)`` whatever K.

    tokens/lengths ``[B]`` as for :func:`decode_step`; steps_budget and
    warm_steps ``[B]`` int; warm_tokens ``[K, B]`` int; ``qparams`` as for
    :func:`decode_step`. Returns ``(cache,
    toks [K, B] int32, logits [K, B, vocab])``; ``cache`` is updated in
    place.
    """
    tok, lens = tokens, lengths
    toks, logits_k = [], []
    for j in range(k):
        live = (j < steps_budget) & (lens > 0)
        step_lens = torch.where(live, lens, torch.zeros_like(lens))
        cache, emitted, logits = decode_step(params, cache, tok, step_lens,
                                             page_table, cfg=cfg,
                                             qparams=qparams)
        if lanes is not None:
            temps, top_ks, top_ps, keys, counters = lanes
            ctr = counters + torch.clamp_min(j - warm_steps, 0)
            emitted = sampling_mod.sample_tokens(
                logits, temps, top_ks, top_ps, keys, ctr, live)
        emitted = emitted.to(torch.int32)
        tok = torch.where(j < warm_steps, warm_tokens[j].to(torch.int32),
                          emitted)
        lens = torch.where(live, lens + 1, lens)
        toks.append(emitted)
        logits_k.append(logits)
    return cache, torch.stack(toks), torch.stack(logits_k)
