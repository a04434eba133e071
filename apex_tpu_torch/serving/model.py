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

The cache tensors are updated in place (the JAX functions return a new
cache; here the same dict is returned, already updated).

Serving constraints (:func:`check_serving_config`): no dropout, no
query-key layer scaling, no MoE, no sequence or context parallelism.
Weight quantization and the multi-token decode block are later slices.

Matmul precision: an fp32 run on the card needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) to
match the JAX numbers; ``chip_smoke.py`` sets it.
"""

import math

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.ops.decode_attention import decode_attention


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


def _trunk_layer(x, lp, cfg, attn):
    """ONE transformer layer of the serving trunk, shared by prefill and
    decode; ``attn(q, k, v)`` owns the cache write and the attention and
    returns the ``[rows, heads*head_dim]`` context."""
    dtype = x.dtype
    ln1 = _layer_norm(x, lp["input_layernorm"], cfg.layernorm_epsilon)
    sa = lp["self_attention"]
    qkv = _mm(ln1, sa["query_key_value"]["weight"], dtype) \
        + sa["query_key_value"]["bias"].to(dtype)
    q, k, v = _split_qkv(qkv, cfg.num_attention_heads, cfg.head_dim)
    ctx = attn(q, k, v)
    attn_out = _mm(ctx, sa["dense"]["weight"], dtype) \
        + sa["dense"]["bias"].to(dtype)
    x = x + attn_out
    ln2 = _layer_norm(x, lp["post_attention_layernorm"],
                      cfg.layernorm_epsilon)
    mlp = lp["mlp"]
    inter = _mm(ln2, mlp["dense_h_to_4h"]["weight"], dtype) \
        + mlp["dense_h_to_4h"]["bias"].to(dtype)
    inter = F.gelu(inter, approximate="tanh")
    out = _mm(inter, mlp["dense_4h_to_h"]["weight"], dtype) \
        + mlp["dense_4h_to_h"]["bias"].to(dtype)
    return x + out


def _embed(params, ids, positions, dtype):
    """Word + position rows summed in the parameter dtype, then cast."""
    x = params["word_embeddings"][ids] \
        + params["embedding"]["position_embeddings"][positions]
    return x.to(dtype)


def _logits(params, x, dtype):
    return _mm(x, params.get("word_logits", params["word_embeddings"]),
               dtype)


# --------------------------------------------------------------- prefill

def prefill(params, cache, ids, positions, seg, token_rows, page_table,
            last_idx, *, cfg):
    """One packed prompt batch through the trunk, filling the cache.

    ids/positions/seg/token_rows: ``[S_pack]`` int tensors — token values,
    their within-request positions, segment ids (0 = padding, 1..R real),
    and each token's row into ``page_table`` (padding rows point at the
    all-null spare row). page_table: ``[R_rows, max_pages]`` int32.
    last_idx: ``[G]`` flat pack indices to gather logits at. Returns
    ``(cache, logits [G, vocab])``; ``cache`` is updated in place.
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

    seg2 = seg.to(torch.int32)[None, :].contiguous()
    for i in range(cfg.num_layers):
        def attn(q, k, v, i=i):
            # scatter this layer's K/V at (page, offset): the token axis of
            # the [S, H, d] values lands on the page/offset pair, heads
            # stay on the head axis (JAX's mixed basic/advanced indexing
            # puts the token axis first; torch's puts it at the index
            # position, hence the [H, S, d] view here)
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

def decode_step(params, cache, tokens, lengths, page_table, *, cfg):
    """One greedy decode step for every slot (q_len = 1).

    tokens/lengths: ``[B]`` int tensors — the token to process and the
    context length INCLUDING it (0 = inactive slot: its writes land on
    the null page, its logits and next token are zeros). page_table:
    ``[B, max_pages]`` int32. Returns ``(cache, next_tokens [B], logits
    [B, vocab])``; ``cache`` is updated in place.
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
    for i in range(cfg.num_layers):
        def attn(q, k, v, i=i):
            # append this step's k/v at (page, offset): [B, H, d] values
            # as an [H, B, d] view for torch's index placement
            cache["k"][i][:, write_page, write_off] = \
                k.to(cache["k"].dtype).transpose(0, 1)
            cache["v"][i][:, write_page, write_off] = \
                v.to(cache["v"].dtype).transpose(0, 1)
            ctx = decode_attention(
                q.to(dtype).contiguous(), cache["k"][i], cache["v"][i],
                page_table, lengths32, sm_scale=1.0 / math.sqrt(hd))
            return ctx.reshape(B, n_heads * hd).to(dtype)

        x = _trunk_layer(x, params["transformer"][f"layer_{i}"], cfg, attn)

    x = _layer_norm(x, params["transformer"]["final_layernorm"],
                    cfg.layernorm_epsilon)
    logits = _logits(params, x, dtype)
    next_tokens = torch.where(
        active, torch.argmax(logits.float(), dim=-1).to(torch.int32), 0)
    return cache, next_tokens, logits
