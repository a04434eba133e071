"""The standalone GPT and BERT (counterpart of
``apex_tpu/transformer/testing/standalone_transformer_lm.py``).

:class:`TransformerConfig` keeps the JAX package's field names and
defaults, so one set of keyword arguments builds the same configuration
on either side. The modules port the training path, in the JAX
package's ``[s, b, h]`` hidden layout and numerics, at tensor-parallel
size 1 or (GPT only), after :func:`apex_tpu_torch.transformer.
parallel_state.initialize_model_parallel`, above it: each rank holds its
shard of the heads, of the MLP's inner width and of the vocabulary (the
word table's rows), and the layers of :mod:`..tensor_parallel` sum over
the tp group.

* :class:`Embedding` (``:663``) — word and position rows (and, with
  ``num_tokentypes``, tokentype rows) summed in the parameter dtype
  (fp32), transposed to ``[s, b, h]``, cast to the compute dtype, then
  hidden dropout in training (``:709``);
* :class:`ParallelAttention` (``:315``), self-attention over this rank's
  ``np / tp`` heads (the fused qkv is interleaved per head, so a
  contiguous shard of its output rows is a shard of the heads), with a
  causal or a padding mask type, routed as the JAX module routes
  (``:398-525``):

  - causal, no explicit mask, no attention dropout: the flash branch
    (``:402-406``, ``:471-482``), :func:`apex_tpu_torch.ops.attention.
    fused_attention` (K1 forward, K5/K6 backward on the card; past head
    dim 256 its scores route, K10/K11);
  - training with attention dropout where the JAX rows kernel takes the
    shape (:func:`_rows_dropout_supported`, JAX's ``attention_pallas.
    supported(..., dropout=True)``): causal with no explicit mask, or
    padding-type with the ``[b, s]`` ``padding_validity`` threaded down
    (:func:`fused_padding_dropout_eligible`), the in-kernel dropout
    route (``:413-470``; K1d, K5d/K6d on the card) with a seed from
    :func:`derive_attention_dropout_seed`, drawn only there; the padding
    form runs non-causal with segment ids ``validity == 0`` on both
    sides, so a valid query sees exactly the valid keys and a pad query
    the pad keys (``:414-422``);
  - every other case the scores path (``:491-524``), the classic
    Megatron attention: ``q / norm_factor`` rounded in the compute
    dtype, the scores ``bmm`` accumulated in fp32 and rounded to the
    compute dtype, :class:`~apex_tpu_torch.transformer.functional.
    FusedScaleMaskSoftmax` with the layer's mask type and the explicit
    ``[b, 1, s, s]`` mask (K10 forward and K11 backward on the card,
    the mask read over heads at stride 0) with ``coeff = layer_number``
    under ``apply_query_key_layer_scaling`` (which forces the softmax
    into fp32, ``:337-342``), dropout on the probabilities in training
    through :func:`apex_tpu_torch.utils.train_dropout`, and the context
    ``bmm``.

  The flash and in-kernel routes scale by ``1/sqrt(hd)``: query-key
  layer scaling is ignored there, as the JAX flash and rows branches
  ignore it. Cross-attention (``AttnType.cross_attn``) is not ported;
* :class:`ParallelMLP` (``:282``) — h→4h/tp, bias + tanh GELU, 4h/tp→h;
* :class:`ParallelTransformerLayer` (``:534``) — pre-LN block with
  ``residual + dropout(x + bias)`` in the compute dtype (``:570-605``);
  with ``recompute_granularity="selective"`` its attention is recomputed
  in the backward (``:553-556``);
* :class:`ParallelTransformer` (``:609``) — the layer stack and the
  final layer norm; with ``"full"`` each layer is recomputed in the
  backward (``:626-630``);
* :func:`parallel_lm_logits` (``:217``) and :class:`GPTModel`
  (``:744``) — causal attention, with an explicit mask on the scores
  path; logits against this rank's shard of the tied word table, and the
  per-token vocab-parallel cross entropy ``[b, s]`` when labels are
  given; or, with ``fused_lm_head=True`` and a shard shape
  :func:`apex_tpu_torch.ops.xent.supported` admits (``_fused_head_applies
  :767``), the fused LM head (``:846-893``) that never materializes the
  logits: at tp = 1 :func:`~apex_tpu_torch.ops.xent.linear_cross_entropy`
  (K7-K9 on the card), above it
  :func:`~apex_tpu_torch.ops.xent.linear_cross_entropy_sharded` (K7p, K8
  and K9 on the shard, the partials combined over the group);
* :class:`TransformerLanguageModel` and :func:`get_language_model`
  (``:896-963``) — embedding, encoder trunk and an optional pooler;
* :class:`Pooler` (``:1002``), :class:`BertLMHead` (``:1078``) and
  :class:`BertModel` (``:1106``) — BERT at tp = 1: padding-type
  attention over the ``[b, s]`` attention mask, the masked-LM head
  (dense, tanh GELU, :class:`FusedLayerNorm`, logits against the tied
  word table plus a vocab bias) and the binary head on the pooled first
  token. Their dense layers follow flax's ``nn.Dense``: fp32 parameters
  and the input promoted to fp32, so in bf16 the head runs in fp32, as
  JAX runs it.

Layer norms are :class:`FusedLayerNorm` (K3/K4 on the card). Parameter
names give ``state_dict`` keys equal to the JAX tree paths with ``/``
→ ``.`` (``transformer.layer_0.self_attention.query_key_value.weight``,
``word_embeddings``; flax ``Dense`` kernels ``[in, out]`` become
``weight [out, in]``), so :func:`apex_tpu_torch.serving.weights.
load_param_tree` carries one tree into either slice.

Dropout in training draws from one ``torch.Generator`` that the caller
passes to :meth:`GPTModel.forward` or :meth:`BertModel.forward` (the
counterpart of flax's "dropout" rng): hidden masks through
:func:`apex_tpu_torch.utils.train_dropout`, and one attention seed per
layer on the in-kernel route, a device tensor, whose mask the kernels
draw from the scores' coordinates. Recompute runs through
``torch.utils.checkpoint`` (non-reentrant). It restores only the default
generators, so the recomputed region restores the explicit generator's
state from before its first forward and puts back the later state after
it: the recompute draws the same masks and seed, and later steps draw
new ones. At tp > 1 every rank draws the same values from its generator
(the hidden masks are equal across ranks), and the attention seed mixes
the rank in. What the slice does not model raises: MoE,
sequence/context parallelism, cross-attention and BERT at tp > 1.
"""

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from apex_tpu_torch import default_device
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import xent
from apex_tpu_torch.ops.attention import (_fmix32, _mul32, fused_attention,
                                          kernel_route)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                             LayerType)
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    _mm,
    _sharded_init,
    scaled_init_std,
    vocab_parallel_embed,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.utils import divide
from apex_tpu_torch.utils import bias_dropout_add, train_dropout


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Shape and numerics options of the GPT and BERT models: the JAX
    package's ``TransformerConfig`` fields that the serving and training
    paths read, same names and defaults (``params_dtype`` is a torch dtype
    here)."""

    hidden_size: int = 256
    num_layers: int = 2
    num_attention_heads: int = 8
    ffn_hidden_size: Optional[int] = None  # default 4*h
    vocab_size: int = 512
    max_position_embeddings: int = 512
    kv_channels: Optional[int] = None  # default h / heads
    layernorm_epsilon: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # training with attention dropout takes the in-kernel dropout route
    # (K1d, K5d/K6d on the card); False takes the scores path (K10, K11)
    fused_attention_dropout: bool = True
    apply_query_key_layer_scaling: bool = True
    attention_softmax_in_fp32: bool = False
    masked_softmax_fusion: bool = True
    # the scores path's softmax: True the fused kernel (K10/K11) where its
    # predicate holds, False the plain function
    softmax_use_pallas: bool = True
    fused_lm_head: Optional[bool] = None
    sequence_parallel: bool = False
    context_parallel_axis: Optional[str] = None
    num_moe_experts: Optional[int] = None
    recompute_granularity: Optional[str] = None
    params_dtype: Any = torch.float32
    fp16: bool = False
    bf16: bool = False
    init_method_std: float = 0.02
    # BERT extras
    bert_binary_head: bool = True

    @property
    def ffn_size(self):
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self):
        if self.kv_channels:
            return self.kv_channels
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"{self.hidden_size} is not divisible by "
                f"{self.num_attention_heads}")
        return self.hidden_size // self.num_attention_heads

    @property
    def compute_in_float16(self):
        return self.fp16 or self.bf16

    @property
    def compute_dtype(self):
        return (torch.bfloat16 if self.bf16
                else torch.float16 if self.fp16 else torch.float32)


def check_training_config(cfg):
    """Raise on TransformerConfig options the training slice does not
    model (dropout is checked per call: it only matters in training).
    Any head dim trains: past the attention kernels' 256 attention takes
    the scores route (:func:`apex_tpu_torch.ops.attention.kernel_route`).
    ``recompute_granularity`` takes None or "none" (no recompute: the port
    has no dispatch table to consult, ``resolve_recompute_granularity
    :713``), "selective" or "full"."""
    problems = []
    if cfg.recompute_granularity not in (None, "none", "selective", "full"):
        problems.append(f"recompute_granularity="
                        f"{cfg.recompute_granularity!r}")
    if cfg.num_moe_experts:
        problems.append("MoE")
    if cfg.sequence_parallel or cfg.context_parallel_axis:
        problems.append("sequence/context parallelism")
    if problems:
        raise ValueError("GPTModel does not support: " + "; ".join(problems))


# the golden-ratio constant that spreads the ranks before the hash
_RANK_MIX = 0x9E3779B9


def derive_attention_dropout_seed(generator, rank=0):
    """The int32 seed of one layer's in-kernel attention dropout on
    tensor-parallel rank ``rank`` (counterpart of ``:1035``, which folds the
    rank into the key), as a ``[1]`` tensor on the generator's device, so
    that no step waits on the host for it. Every rank draws the same value
    in ``[-2**31, 2**31 - 1)`` from ``generator`` (so the ranks' generators
    stay in step); rank 0 keeps it as it is, and rank r > 0 takes murmur3's
    fmix32 of ``draw ^ (r * 0x9E3779B9 mod 2**32)`` as uint32, read back as
    int32, so that the ranks' head shards draw different masks."""
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)
    if rank == 0:
        return seed
    mixed = _fmix32((seed.long() & 0xFFFFFFFF)
                    ^ _mul32(torch.tensor(int(rank), device=seed.device),
                             _RANK_MIX))
    return torch.where(mixed >= 2 ** 31, mixed - 2 ** 32, mixed).to(
        torch.int32)


# the longest key row the JAX rows kernel takes with dropout
# (``attention_pallas.supported(sq, sk, d, dropout=True)``): its backward
# keeps six [bq, sk] fp32 arrays of a q block of at least 8 rows within a
# 10 MiB budget, so sk <= 10 MiB / (4 * 6 * 8) = 54613 (54528 with the
# multiple of 128)
_ROWS_DROPOUT_MAX_KEYS = (10 << 20) // (4 * 6 * 8)


def _rows_dropout_supported(sq, sk, hd):
    """JAX's ``attention_pallas.supported(sq, sk, hd, dropout=True)``: the
    in-kernel dropout route's shapes. The port's kernels tile any length,
    but the route is JAX's choice, and the two routes give different
    numbers (another dropout draw; on the padding route, other pad
    rows), so the port takes it exactly where JAX does: keys a multiple
    of 128 and at most ``_ROWS_DROPOUT_MAX_KEYS``, queries a multiple of
    8 (a q block of 8 rows), and a head dim the kernels take."""
    return (sk % 128 == 0 and sk <= _ROWS_DROPOUT_MAX_KEYS and sq % 8 == 0
            and kernel_route(hd) == "kernels")


def fused_padding_dropout_eligible(cfg, deterministic, s_len, hd):
    """Whether padding-type self-attention trains with dropout on the
    in-kernel route with segment ids (``:1049``). :class:`BertModel`
    skips the ``[b, 1, s, s]`` extended mask exactly when this holds,
    since no layer's attention will read it."""
    return (cfg.fused_attention_dropout
            and not deterministic
            and cfg.attention_dropout > 0.0
            and cfg.context_parallel_axis is None
            and _rows_dropout_supported(s_len, s_len, hd))


def bert_extended_attention_mask(attention_mask):
    """``[b, s]`` (1 = attend) → ``[b, 1, s, s]`` bool, True = masked out
    (``:1063``): a pair is kept where both its query and its key are
    valid."""
    m = attention_mask.bool()
    return ~(m[:, None, None, :] & m[:, None, :, None])


def bert_position_ids(token_ids):
    """``[b, s]`` positions ``0 .. s-1`` on every row (``:1071``)."""
    b, s = token_ids.shape
    return torch.arange(s, device=token_ids.device)[None].expand(b, s)


@contextlib.contextmanager
def _generator_at(generator, state):
    """Run the block with ``generator`` at ``state``, then put back the
    state it had on entry."""
    outer = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(outer)


def _recomputed(fn, generator, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant). The recompute starts from
    the generator state of the first forward, so it draws the same
    dropout masks and seeds, and leaves the generator where it found it."""
    if generator is None:
        context_fn = checkpoint.noop_context_fn
    else:
        state = generator.get_state()

        def context_fn():
            return contextlib.nullcontext(), _generator_at(generator, state)
    return checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=context_fn)


def parallel_lm_logits(hidden, word_embeddings_weight, bias=None):
    """Logits against this rank's shard of the tied word table (the
    hidden through copy-to, so its gradient sums over the tp group): the
    table cast to the hidden dtype, fp32 accumulation, rounded to the
    hidden dtype; ``[..., vocab / tp]``, not gathered."""
    hidden = copy_to_tensor_model_parallel_region(hidden)
    logits = _mm(hidden, word_embeddings_weight)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    return logits


class ParallelMLP(nn.Module):
    """h → 4h (column, this rank's 4h / tp) → tanh GELU → h (row)."""

    def __init__(self, cfg, device, generator):
        super().__init__()
        std = cfg.init_method_std
        kw = dict(skip_bias_add=True, params_dtype=cfg.params_dtype,
                  device=device, generator=generator)
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_size, gather_output=False, init_std=std,
            **kw)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn_size, cfg.hidden_size, input_is_parallel=True,
            init_std=scaled_init_std(std, cfg.num_layers), **kw)

    def forward(self, hidden):
        inter, bias = self.dense_h_to_4h(hidden)
        inter = F.gelu(inter + bias.to(inter.dtype), approximate="tanh")
        return self.dense_4h_to_h(inter)


class ParallelAttention(nn.Module):
    """Self-attention with mask type ``attn_mask_type`` (padding, as in
    JAX, or causal); returns ``(out, bias)``. The route, as the JAX module
    takes it (see the module docstring): the flash branch for causal
    attention with no explicit mask and no attention dropout; in training
    (a generator) with attention dropout and ``fused_attention_dropout``,
    the in-kernel dropout route where :func:`_rows_dropout_supported`
    holds, causal with no explicit mask or padding-type with
    ``padding_validity`` (:func:`fused_padding_dropout_eligible`); else
    the scores path with ``attention_mask`` (``[b, 1, s, s]`` bool, True
    = masked out)."""

    def __init__(self, cfg, device, generator, layer_number=1,
                 attention_type=AttnType.self_attn,
                 attn_mask_type=AttnMaskType.padding):
        super().__init__()
        if attention_type != AttnType.self_attn:
            raise ValueError("ParallelAttention: cross-attention is not "
                             "ported")
        self.cfg = cfg
        self.attn_mask_type = attn_mask_type
        proj = cfg.num_attention_heads * cfg.head_dim
        kw = dict(params_dtype=cfg.params_dtype, device=device,
                  generator=generator)
        self.num_local_heads = divide(
            cfg.num_attention_heads,
            parallel_state.get_tensor_model_parallel_world_size())
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, 3 * proj, gather_output=False,
            init_std=cfg.init_method_std, **kw)
        self.dense = RowParallelLinear(
            proj, cfg.hidden_size, input_is_parallel=True, skip_bias_add=True,
            init_std=scaled_init_std(cfg.init_method_std, cfg.num_layers),
            **kw)
        # the scores path's scaling (:331-343): query-key layer scaling
        # divides q by layer_number more and multiplies the scores back
        # inside the fp32 softmax
        layer_number = max(1, int(layer_number))
        self.norm_factor = math.sqrt(cfg.head_dim)
        coeff = None
        softmax_in_fp32 = cfg.attention_softmax_in_fp32
        if cfg.apply_query_key_layer_scaling:
            coeff = float(layer_number)
            self.norm_factor *= coeff
            softmax_in_fp32 = True
        self.scale_mask_softmax = FusedScaleMaskSoftmax(
            cfg.fp16, cfg.bf16, attn_mask_type,
            cfg.masked_softmax_fusion, attention_mask_func, softmax_in_fp32,
            coeff, use_pallas=cfg.softmax_use_pallas)

    def forward(self, hidden, attention_mask=None, generator=None,
                padding_validity=None):
        cfg = self.cfg
        np_, hd = self.num_local_heads, cfg.head_dim
        s, b = hidden.shape[0], hidden.shape[1]
        qkv = self.query_key_value(hidden).reshape(s, b, np_, 3 * hd)
        q, k, v = torch.split(qkv, hd, dim=-1)          # [s, b, np, hd]
        training = generator is not None
        dropout = training and cfg.attention_dropout > 0.0
        causal = self.attn_mask_type == AttnMaskType.causal
        use_flash = causal and attention_mask is None and not dropout
        drop_causal = causal and attention_mask is None
        drop_padding = (not causal and padding_validity is not None
                        and fused_padding_dropout_eligible(
                            cfg, not training, s, hd))
        if (not use_flash and (drop_causal or drop_padding) and dropout
                and cfg.fused_attention_dropout
                and _rows_dropout_supported(s, s, hd)):
            segs = None
            if drop_padding:
                # segment ids, valid = 0 and pad = 1 (:462-463)
                pad_ids = (padding_validity.to(torch.int32) == 0).to(
                    torch.int32).contiguous()
                segs = (pad_ids, pad_ids)
            seed = derive_attention_dropout_seed(
                generator, parallel_state.get_tensor_model_parallel_rank())
            return self._via_bhsd(q, k, v, causal=drop_causal,
                                  segment_ids=segs,
                                  dropout_p=float(cfg.attention_dropout),
                                  dropout_seed=seed)
        if use_flash:
            return self._via_bhsd(q, k, v, causal=True)
        ctx = self._scores_path(q, k, v, attention_mask, generator)
        return self.dense(ctx)

    def _via_bhsd(self, q, k, v, **kw):
        """``[s, b, np, hd]`` q/k/v → :func:`fused_attention` over ``[b,
        np, s, hd]`` at scale ``1/sqrt(hd)`` → ``[s, b, np*hd]`` → the
        output projection (``_via_bhsd :387-396``)."""
        s, b, np_, hd = q.shape
        q, k, v = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))
        ctx = fused_attention(q, k, v, sm_scale=1.0 / math.sqrt(hd), **kw)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, np_ * hd)
        return self.dense(ctx)

    def _scores_path(self, q, k, v, attention_mask, generator):
        """Scores → fused scale-mask softmax → dropout in training →
        context, on ``[s, b, np, hd]`` q/k/v; returns the ``[s, b,
        np*hd]`` context."""
        s, b, np_, hd = q.shape
        dtype = q.dtype

        def to_bns(x):
            # [s, b, np, hd] → [b*np, s, hd] for the batched matmuls
            return x.permute(1, 2, 0, 3).reshape(b * np_, s, hd)

        qb, kb, vb = to_bns(q), to_bns(k), to_bns(v)
        # q / norm_factor in the compute dtype, divided by a tensor on the
        # device (a Python float divisor becomes a reciprocal multiply on
        # the card); the products accumulate in fp32 and round to dtype
        norm = torch.full((), self.norm_factor, dtype=dtype, device=q.device)
        scores = torch.bmm(qb / norm, kb.transpose(1, 2))
        probs = self.scale_mask_softmax(scores.reshape(b, np_, s, s),
                                        attention_mask)
        if generator is not None and self.cfg.attention_dropout > 0.0:
            probs = train_dropout(generator, probs,
                                  self.cfg.attention_dropout)
        ctx = torch.bmm(probs.reshape(b * np_, s, s).to(vb.dtype), vb)
        return ctx.reshape(b, np_, s, hd).permute(2, 0, 1, 3).reshape(
            s, b, np_ * hd)


def attention_mask_func(attention_scores, attention_mask):
    """Masked positions → -10000 (the unfused softmax's mask)."""
    fill = torch.full((), -10000.0, dtype=attention_scores.dtype,
                      device=attention_scores.device)
    return torch.where(attention_mask, fill, attention_scores)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN → attention → residual + dropout → LN → MLP →
    residual + dropout. ``generator`` (None outside training) draws the
    dropout masks and the attention seed; ``attention_mask`` and
    ``padding_validity`` go to the attention. The encoder layer type only
    (the decoder's cross-attention is not ported)."""

    def __init__(self, cfg, device, generator, layer_number=1,
                 layer_type=LayerType.encoder,
                 self_attn_mask_type=AttnMaskType.padding):
        super().__init__()
        if layer_type != LayerType.encoder:
            raise ValueError("ParallelTransformerLayer: the decoder layer "
                             "type (cross-attention) is not ported")
        self.cfg = cfg
        ln = dict(eps=cfg.layernorm_epsilon, device=device)
        self.input_layernorm = FusedLayerNorm(cfg.hidden_size, **ln)
        self.self_attention = ParallelAttention(
            cfg, device, generator, layer_number,
            attn_mask_type=self_attn_mask_type)
        self.post_attention_layernorm = FusedLayerNorm(cfg.hidden_size, **ln)
        self.mlp = ParallelMLP(cfg, device, generator)

    def forward(self, hidden, attention_mask=None, generator=None,
                padding_validity=None):
        cfg = self.cfg
        p, training = cfg.hidden_dropout, generator is not None
        ln_out = self.input_layernorm(hidden)
        if cfg.recompute_granularity == "selective":
            out, bias = _recomputed(
                lambda x: self.self_attention(x, attention_mask, generator,
                                              padding_validity),
                generator, ln_out)
        else:
            out, bias = self.self_attention(ln_out, attention_mask, generator,
                                            padding_validity)
        hidden = bias_dropout_add(out, bias.to(out.dtype), hidden, p,
                                  training, generator)
        out, bias = self.mlp(self.post_attention_layernorm(hidden))
        return bias_dropout_add(out, bias.to(out.dtype), hidden, p, training,
                                generator)


class ParallelTransformer(nn.Module):
    """``layer_0 .. layer_{n-1}`` with self-attention of mask type
    ``self_attn_mask_type`` (padding, as in JAX, or causal) and
    ``final_layernorm``."""

    def __init__(self, cfg, device, generator,
                 self_attn_mask_type=AttnMaskType.padding):
        super().__init__()
        self.num_layers = cfg.num_layers
        self.recompute = cfg.recompute_granularity == "full"
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ParallelTransformerLayer(
                cfg, device, generator, layer_number=i + 1,
                self_attn_mask_type=self_attn_mask_type))
        self.final_layernorm = FusedLayerNorm(
            cfg.hidden_size, eps=cfg.layernorm_epsilon, device=device)

    def forward(self, hidden, attention_mask=None, generator=None,
                padding_validity=None):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.recompute:
                hidden = _recomputed(
                    lambda x, layer=layer: layer(x, attention_mask,
                                                 generator, padding_validity),
                    generator, hidden)
            else:
                hidden = layer(hidden, attention_mask, generator,
                               padding_validity)
        return self.final_layernorm(hidden)


class Embedding(nn.Module):
    """Position table, an optional tokentype table (``num_tokentypes >
    0``; it exists whether or not ids are passed, as in JAX) and the word
    + position (+ tokentype) sum (the word table is owned by the model and
    passed in, as in the JAX package)."""

    def __init__(self, cfg, device, generator, num_tokentypes=0):
        super().__init__()
        self.cfg = cfg
        self.num_tokentypes = num_tokentypes
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size,
            dtype=cfg.params_dtype, device=device).normal_(
                0.0, cfg.init_method_std, generator=generator))
        if num_tokentypes > 0:
            self.tokentype_embeddings = nn.Parameter(torch.empty(
                num_tokentypes, cfg.hidden_size, dtype=cfg.params_dtype,
                device=device).normal_(0.0, cfg.init_method_std,
                                       generator=generator))

    def forward(self, word_embeddings, input_ids, position_ids,
                tokentype_ids=None, generator=None):
        cfg = self.cfg
        emb = (vocab_parallel_embed(word_embeddings, input_ids)
               + self.position_embeddings[position_ids])
        if tokentype_ids is not None:
            if self.num_tokentypes == 0:
                raise ValueError("Embedding: tokentype_ids passed to an "
                                 "Embedding built with num_tokentypes=0")
            emb = emb + self.tokentype_embeddings[tokentype_ids]
        emb = emb.transpose(0, 1)                     # [b, s, h] → [s, b, h]
        if cfg.compute_in_float16:
            emb = emb.to(cfg.compute_dtype)
        emb = emb.contiguous()
        if generator is not None and cfg.hidden_dropout > 0.0:
            emb = train_dropout(generator, emb, cfg.hidden_dropout)
        return emb


def _dropout_generator(cfg, deterministic, dropout_generator, who):
    """The generator a forward draws its dropout from: None when
    deterministic or when both rates are 0, else ``dropout_generator``,
    which is then required."""
    if deterministic or (cfg.hidden_dropout == 0
                         and cfg.attention_dropout == 0):
        return None
    if dropout_generator is None:
        raise ValueError(f"{who}: training with dropout (deterministic="
                         f"False) needs a dropout_generator")
    return dropout_generator


def _model_generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _word_embeddings_param(cfg, device, generator):
    """The vocab-sharded tied word table every LM head reuses."""
    return nn.Parameter(_sharded_init(
        (cfg.vocab_size, cfg.hidden_size), 0, cfg.init_method_std,
        cfg.params_dtype, device, generator))


class GPTModel(nn.Module):
    """GPT language model, at tensor-parallel size ``tp_size`` (which must
    be the size :mod:`..parallel_state` was initialized with; 1 without).

    ``forward(input_ids, position_ids, attention_mask=None, labels=None,
    deterministic=True, dropout_generator=None)``: ids and positions ``[b,
    s]``; ``attention_mask`` an optional ``[b, 1, s, s]`` bool mask (True
    = masked out) that takes causal attention off the flash branch onto
    the scores path (``:816-841``), where the fused causal softmax ignores
    it and the unfused one ORs it with the triangle, as in JAX;
    ``deterministic=False`` trains with the configuration's hidden
    and attention dropout, drawn from ``dropout_generator`` (a
    ``torch.Generator`` on the model's device; required when either rate
    is above 0), as the JAX model draws from its "dropout" rng; returns
    the fp32
    per-token loss ``[b, s]`` when labels are given, else this rank's
    logits ``[b, s, vocab / tp]`` in the compute dtype. With labels,
    ``cfg.fused_lm_head`` True and a shard shape :func:`xent.supported`
    admits (``b*s, vocab / tp, h``), the loss comes from
    :func:`xent.linear_cross_entropy` (tp = 1) or
    :func:`xent.linear_cross_entropy_sharded` (tp > 1, dX summed over the
    group) over the ``[b*s, h]`` hidden in ``[b, s]`` row order (the JAX
    ``:866-879``); otherwise, and always without labels, from the
    materialized logits and the vocab-parallel cross entropy,
    as the JAX model runs with ``APEX_DISPATCH=off`` (the port has no
    dispatch table, so ``None`` means the materialized head). Parameters
    are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``
    means ``cuda``): normal(0, ``init_method_std``), the two output
    projections scaled by ``1/sqrt(2 num_layers)``, zero biases, unit
    layer-norm scales; each sharded weight is drawn at full shape and
    sliced, so every rank holds its shard of the model tp = 1 builds from
    the same seed. Parity runs load a JAX tree instead
    (:func:`apex_tpu_torch.serving.weights.load_param_tree`, after
    :func:`~apex_tpu_torch.serving.weights.shard_param_tree` at tp > 1).
    """

    def __init__(self, cfg, device=None, seed=0, tp_size=1):
        super().__init__()
        check_training_config(cfg)
        self.tp_size = parallel_state.get_tensor_model_parallel_world_size()
        if tp_size != self.tp_size:
            raise ValueError(
                f"GPTModel: tensor-parallel size {tp_size}, but the "
                f"tensor-parallel group has {self.tp_size} rank(s); call "
                f"parallel_state.initialize_model_parallel({tp_size}, "
                f"backend=...) first")
        device = default_device(device)
        gen = _model_generator(seed, device)
        self.cfg = cfg
        self.word_embeddings = _word_embeddings_param(cfg, device, gen)
        self.embedding = Embedding(cfg, device, gen)
        self.transformer = ParallelTransformer(
            cfg, device, gen, self_attn_mask_type=AttnMaskType.causal)

    def forward(self, input_ids, position_ids, attention_mask=None,
                labels=None, deterministic=True, dropout_generator=None):
        cfg = self.cfg
        gen = _dropout_generator(cfg, deterministic, dropout_generator,
                                 "GPTModel")
        hidden = self.embedding(self.word_embeddings, input_ids, position_ids,
                                generator=gen)
        hidden = self.transformer(hidden, attention_mask, gen)
        s, b, h = hidden.shape
        if (labels is not None and cfg.fused_lm_head
                and xent.supported(b * s, cfg.vocab_size // self.tp_size,
                                   h)):
            x2d = hidden.transpose(0, 1).reshape(b * s, h)
            table = self.word_embeddings.to(x2d.dtype)
            if self.tp_size == 1:
                loss = xent.linear_cross_entropy(x2d, table,
                                                 labels.reshape(-1))
            else:
                loss = xent.linear_cross_entropy_sharded(
                    x2d, table, labels.reshape(-1),
                    parallel_state.get_tensor_model_parallel_group())
            return loss.reshape(b, s)
        logits = parallel_lm_logits(hidden, self.word_embeddings)
        logits = logits.transpose(0, 1)               # [s, b, v] → [b, s, v]
        if labels is None:
            return logits
        return vocab_parallel_cross_entropy(logits, labels)


def _whole_model(who, pre_process, post_process):
    if not (pre_process and post_process):
        raise ValueError(f"{who}: pipeline stages (pre_process/"
                         f"post_process False) are not ported")


# flax's nn.Dense default kernel init, lecun_normal: a normal truncated at
# two standard deviations, scaled so that its variance is 1 / fan_in
# (variance_scaling's truncation constant)
_LECUN_TRUNCATION = 0.87962566103423978


class _Dense(nn.Module):
    """flax's ``nn.Dense`` (``dtype=None``): ``weight [out, in]`` (flax's
    ``kernel [in, out]`` transposed) and a zero ``bias [out]`` in
    ``params_dtype``; the input and the parameters promoted to their
    common dtype before the product, so a bf16 input over fp32 parameters
    computes in fp32, as flax promotes. ``init_std`` None draws flax's
    ``lecun_normal``, else normal(0, ``init_std``)."""

    def __init__(self, in_features, out_features, device, generator,
                 params_dtype=torch.float32, init_std=None):
        super().__init__()
        weight = torch.empty(out_features, in_features, dtype=params_dtype,
                             device=device)
        if init_std is None:
            std = math.sqrt(1.0 / in_features) / _LECUN_TRUNCATION
            nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        else:
            weight.normal_(0.0, init_std, generator=generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=params_dtype,
                                             device=device))

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


class Pooler(nn.Module):
    """``tanh(dense(hidden[sequence_index]))`` on an ``[s, b, h]`` input
    (``:1002-1030``); the dense weight normal(0, ``init_std``)."""

    def __init__(self, hidden_size, init_std=0.02, params_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.dense = _Dense(hidden_size, hidden_size, default_device(device),
                            generator, params_dtype, init_std)

    def forward(self, hidden_states, sequence_index=0):
        return torch.tanh(self.dense(hidden_states[sequence_index]))


class BertLMHead(nn.Module):
    """The masked-LM head (``:1078-1103``): dense (flax's default init),
    tanh GELU, :class:`FusedLayerNorm`, then the logits against the tied
    word table plus a zero-initialized vocab bias, through
    :func:`parallel_lm_logits`. Input ``[s, b, h]``; returns ``[s, b,
    vocab]``, in fp32 where the dense promotes a half input."""

    def __init__(self, cfg, device, generator):
        super().__init__()
        self.dense = _Dense(cfg.hidden_size, cfg.hidden_size, device,
                            generator, cfg.params_dtype)
        self.layernorm = FusedLayerNorm(cfg.hidden_size,
                                        eps=cfg.layernorm_epsilon,
                                        device=device)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                             dtype=cfg.params_dtype,
                                             device=device))

    def forward(self, hidden, word_embeddings):
        h = self.layernorm(F.gelu(self.dense(hidden), approximate="tanh"))
        return parallel_lm_logits(h, word_embeddings, bias=self.bias)


def _refuse_tensor_parallel(who):
    tp = parallel_state.get_tensor_model_parallel_world_size()
    if tp != 1:
        raise ValueError(f"{who}: tensor-parallel size {tp}; the port takes "
                         f"BERT and the language model at tp = 1 only")


class BertModel(nn.Module):
    """BERT: a bidirectional encoder with the masked-LM head and, with
    ``cfg.bert_binary_head``, the pooler and the binary (NSP) head
    (``:1106-1180``), at tensor-parallel size 1.

    ``forward(input_ids, attention_mask, tokentype_ids=None,
    lm_labels=None, deterministic=True, dropout_generator=None)``: ids and
    the attention mask ``[b, s]`` (1 = attend); returns ``(lm_loss [b, s],
    binary_logits)`` with labels, else ``(lm_logits [b, s, vocab],
    binary_logits)`` (``binary_logits`` ``[b, 2]``, or None without the
    binary head). The loss is the vocab-parallel cross entropy of the
    materialized logits at every position, with no loss mask, as JAX
    computes it. The attention is padding-type: the ``[b, 1, s, s]``
    extended mask on the scores path (K10's mask mode on the card), or,
    in training with attention dropout where
    :func:`fused_padding_dropout_eligible` holds, the in-kernel dropout
    route with segment ids from the mask (K1d, K5d/K6d), in which case the
    extended mask is not built (``:1126-1134``). ``deterministic`` and
    ``dropout_generator`` as in :class:`GPTModel`. Parameters are drawn
    from ``torch.Generator(seed)`` on ``device`` as :class:`GPTModel`
    draws them, and two tokentypes' rows normal(0, ``init_method_std``),
    the pooler's dense likewise, the LM head's dense and the binary head
    from flax's ``lecun_normal``, zero biases."""

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        check_training_config(cfg)
        _refuse_tensor_parallel("BertModel")
        device = default_device(device)
        gen = _model_generator(seed, device)
        self.cfg = cfg
        self.word_embeddings = _word_embeddings_param(cfg, device, gen)
        self.embedding = Embedding(cfg, device, gen, num_tokentypes=2)
        self.transformer = ParallelTransformer(
            cfg, device, gen, self_attn_mask_type=AttnMaskType.padding)
        self.lm_head = BertLMHead(cfg, device, gen)
        if cfg.bert_binary_head:
            self.pooler = Pooler(cfg.hidden_size, cfg.init_method_std,
                                 cfg.params_dtype, device, gen)
            self.binary_head = _Dense(cfg.hidden_size, 2, device, gen,
                                      cfg.params_dtype)

    def forward(self, input_ids, attention_mask, tokentype_ids=None,
                lm_labels=None, deterministic=True, dropout_generator=None):
        cfg = self.cfg
        gen = _dropout_generator(cfg, deterministic, dropout_generator,
                                 "BertModel")
        position_ids = bert_position_ids(input_ids)
        ext_mask = None
        if not fused_padding_dropout_eligible(cfg, gen is None,
                                              input_ids.shape[1],
                                              cfg.head_dim):
            ext_mask = bert_extended_attention_mask(attention_mask)
        hidden = self.embedding(self.word_embeddings, input_ids, position_ids,
                                tokentype_ids, gen)
        hidden = self.transformer(hidden, ext_mask, gen,
                                  padding_validity=attention_mask)
        lm_logits = self.lm_head(hidden, self.word_embeddings).transpose(0, 1)
        binary_logits = None
        if cfg.bert_binary_head:
            binary_logits = self.binary_head(self.pooler(hidden))
        if lm_labels is None:
            return lm_logits, binary_logits
        return vocab_parallel_cross_entropy(lm_logits, lm_labels), \
            binary_logits


def bert_model_provider(cfg, pre_process=True, post_process=True, **kwargs):
    """A :class:`BertModel` (``:1183``); ``kwargs`` go to its constructor.
    Pipeline stages are not ported."""
    _whole_model("bert_model_provider", pre_process, post_process)
    return BertModel(cfg, **kwargs)


class TransformerLanguageModel(nn.Module):
    """Embedding + encoder trunk (+ the pooler with ``add_pooler``), the
    composite the heads build on (``:896-955``), at tensor-parallel size
    1. ``forward(enc_input_ids, enc_position_ids, enc_attn_mask,
    tokentype_ids=None, pooling_sequence_index=0, deterministic=True,
    dropout_generator=None)`` returns ``(encoder_output,
    word_embeddings)``, or ``(encoder_output, pooled_output,
    word_embeddings)`` with the pooler; ``enc_attn_mask`` is the
    ``[b, 1, s, s]`` mask (True = masked out) or None. No padding validity
    reaches the trunk, so attention dropout takes the scores path, as in
    JAX."""

    def __init__(self, cfg, device=None, seed=0, num_tokentypes=0,
                 add_pooler=False,
                 encoder_attn_mask_type=AttnMaskType.padding):
        super().__init__()
        check_training_config(cfg)
        _refuse_tensor_parallel("TransformerLanguageModel")
        device = default_device(device)
        gen = _model_generator(seed, device)
        self.cfg = cfg
        self.add_pooler = add_pooler
        self.word_embeddings = _word_embeddings_param(cfg, device, gen)
        self.embedding = Embedding(cfg, device, gen, num_tokentypes)
        self.encoder = ParallelTransformer(
            cfg, device, gen, self_attn_mask_type=encoder_attn_mask_type)
        if add_pooler:
            self.pooler = Pooler(cfg.hidden_size, cfg.init_method_std,
                                 cfg.params_dtype, device, gen)

    def forward(self, enc_input_ids, enc_position_ids, enc_attn_mask,
                tokentype_ids=None, pooling_sequence_index=0,
                deterministic=True, dropout_generator=None):
        gen = _dropout_generator(self.cfg, deterministic, dropout_generator,
                                 "TransformerLanguageModel")
        hidden = self.embedding(self.word_embeddings, enc_input_ids,
                                enc_position_ids, tokentype_ids, gen)
        encoder_output = self.encoder(hidden, enc_attn_mask, gen)
        if self.add_pooler:
            pooled = self.pooler(encoder_output, pooling_sequence_index)
            return encoder_output, pooled, self.word_embeddings
        return encoder_output, self.word_embeddings


def get_language_model(cfg, num_tokentypes=0, add_pooler=False,
                       encoder_attn_mask_type=AttnMaskType.padding,
                       pre_process=True, post_process=True, device=None,
                       seed=0, **unused):
    """``(TransformerLanguageModel, "language_model")`` (``:958-963``).
    Pipeline stages are not ported."""
    _whole_model("get_language_model", pre_process, post_process)
    model = TransformerLanguageModel(
        cfg, device=device, seed=seed, num_tokentypes=num_tokentypes,
        add_pooler=add_pooler, encoder_attn_mask_type=encoder_attn_mask_type)
    return model, "language_model"
