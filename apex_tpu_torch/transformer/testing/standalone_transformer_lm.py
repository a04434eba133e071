"""The standalone GPT (counterpart of
``apex_tpu/transformer/testing/standalone_transformer_lm.py``).

:class:`TransformerConfig` keeps the JAX package's field names and
defaults, so one set of keyword arguments builds the same configuration
on either side. The modules port the training path, in the JAX
package's ``[s, b, h]`` hidden layout and numerics, at tensor-parallel
size 1 or, after :func:`apex_tpu_torch.transformer.parallel_state.
initialize_model_parallel`, above it: each rank holds its shard of the
heads, of the MLP's inner width and of the vocabulary (the word table's
rows), and the layers of :mod:`..tensor_parallel` sum over the tp group.

* :class:`Embedding` (``:663``) — word and position rows summed in the
  parameter dtype (fp32), transposed to ``[s, b, h]``, cast to the
  compute dtype, then hidden dropout in training (``:709``);
* :class:`ParallelAttention` (``:315``) over this rank's ``np / tp``
  heads (the fused qkv is interleaved per head, so a contiguous shard of
  its output rows is a shard of the heads) — the causal, no-mask branches:
  without dropout the flash branch (``:402-406``, ``:471-482``), in
  training with attention dropout the in-kernel dropout route
  (``:421-470``) with a seed from :func:`derive_attention_dropout_seed`;
  the fused qkv projection split per head ``[q|k|v]`` (``:352-355``), the
  ``[b, h, s, d]`` attention of
  :func:`apex_tpu_torch.ops.attention.fused_attention` (K1 or K1d
  forward, K5/K6 or K5d/K6d backward on the card; past head dim 256 its
  scores route, K10/K11, and with attention dropout the scores path
  below) at scale ``1/sqrt(hd)``
  — query-key layer scaling is ignored, as the JAX flash and rows
  branches ignore it — and the output projection (``_via_bhsd
  :387-396``). In training with attention dropout and
  ``fused_attention_dropout=False`` it takes the scores path
  (``:491-524``), the classic Megatron attention: ``q / norm_factor``
  rounded in the compute dtype, the scores ``bmm`` accumulated in fp32
  and rounded to the compute dtype,
  :class:`~apex_tpu_torch.transformer.functional.FusedScaleMaskSoftmax`
  (K10 forward and K11 backward on the card) with ``coeff = layer_number``
  under ``apply_query_key_layer_scaling`` (which forces the softmax into
  fp32, ``:337-342``), dropout on the probabilities through
  :func:`apex_tpu_torch.utils.train_dropout`, and the context ``bmm``;
* :class:`ParallelMLP` (``:282``) — h→4h/tp, bias + tanh GELU, 4h/tp→h;
* :class:`ParallelTransformerLayer` (``:534``) — pre-LN block with
  ``residual + dropout(x + bias)`` in the compute dtype (``:570-605``);
  with ``recompute_granularity="selective"`` its attention is recomputed
  in the backward (``:553-556``);
* :class:`ParallelTransformer` (``:609``) — the layer stack and the
  final layer norm; with ``"full"`` each layer is recomputed in the
  backward (``:626-630``);
* :func:`parallel_lm_logits` (``:217``) and :class:`GPTModel`
  (``:744``) — logits against this rank's shard of the tied word table,
  and the per-token vocab-parallel cross entropy ``[b, s]`` when labels
  are given; or, with ``fused_lm_head=True`` and a shard shape
  :func:`apex_tpu_torch.ops.xent.supported` admits (``_fused_head_applies
  :767``), the fused LM head (``:846-893``) that never materializes the
  logits: at tp = 1 :func:`~apex_tpu_torch.ops.xent.linear_cross_entropy`
  (K7-K9 on the card), above it
  :func:`~apex_tpu_torch.ops.xent.linear_cross_entropy_sharded` (K7p, K8
  and K9 on the shard, the partials combined over the group).

Layer norms are :class:`FusedLayerNorm` (K3/K4 on the card). Parameter
names give ``state_dict`` keys equal to the JAX tree paths with ``/``
→ ``.`` (``transformer.layer_0.self_attention.query_key_value.weight``,
``word_embeddings``), so :func:`apex_tpu_torch.serving.weights.
load_param_tree` carries one tree into either slice.

Dropout in training draws from one ``torch.Generator`` that the caller
passes to :meth:`GPTModel.forward` (the counterpart of flax's "dropout"
rng): hidden masks through :func:`apex_tpu_torch.utils.train_dropout`,
and one attention seed per layer, a device tensor, whose mask the kernels
draw from the scores' coordinates. Recompute runs through
``torch.utils.checkpoint`` (non-reentrant). It restores only the default
generators, so the recomputed region restores the explicit generator's
state from before its first forward and puts back the later state after
it: the recompute draws the same masks and seed, and later steps draw
new ones. At tp > 1 every rank draws the same values from its generator
(the hidden masks are equal across ranks), and the attention seed mixes
the rank in. What the slice does not model raises: MoE,
sequence/context parallelism, and an explicit ``attention_mask``.
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
from apex_tpu_torch.transformer.enums import AttnMaskType
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
    """Shape and numerics options of the GPT model: the JAX package's
    ``TransformerConfig`` fields that the serving and training paths
    read, same names and defaults (``params_dtype`` is a torch dtype
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
    """Causal self-attention (no mask); returns ``(out, bias)``. Without
    a generator or attention dropout, :func:`fused_attention`. With a
    generator and ``attention_dropout > 0``, the in-kernel dropout route
    (``:421-470``, one seed per call from
    :func:`derive_attention_dropout_seed`), or with
    ``fused_attention_dropout=False`` the scores path (``:491-524``). The
    port's kernels tile any key length, so there is no fallback to the
    scores path where the JAX ``supported(..., dropout=True)`` fails on
    the key length (``:456-458``); that fallback computes the same
    dropout distribution. Where it fails on the head dim (past 256,
    :func:`kernel_route`), both packages take the scores path."""

    def __init__(self, cfg, device, generator, layer_number=1):
        super().__init__()
        self.cfg = cfg
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
            cfg.fp16, cfg.bf16, AttnMaskType.causal,
            cfg.masked_softmax_fusion, attention_mask_func, softmax_in_fp32,
            coeff, use_pallas=cfg.softmax_use_pallas)

    def forward(self, hidden, attention_mask=None, generator=None):
        if attention_mask is not None:
            raise ValueError("ParallelAttention: only the causal branch with "
                             "no explicit mask is ported")
        cfg = self.cfg
        np_, hd = self.num_local_heads, cfg.head_dim
        s, b = hidden.shape[0], hidden.shape[1]
        qkv = self.query_key_value(hidden).reshape(s, b, np_, 3 * hd)
        q, k, v = torch.split(qkv, hd, dim=-1)          # [s, b, np, hd]
        dropout = generator is not None and cfg.attention_dropout > 0.0
        # past the in-kernel route's head dims the JAX model falls through
        # to the scores path (:456-458)
        if dropout and (not cfg.fused_attention_dropout
                        or kernel_route(hd) == "scores"):
            ctx = self._scores_path(q, k, v, generator)
            return self.dense(ctx)
        q, k, v = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))
        drop = {}
        if dropout:
            drop = dict(dropout_p=float(cfg.attention_dropout),
                        dropout_seed=derive_attention_dropout_seed(
                            generator,
                            parallel_state.get_tensor_model_parallel_rank()))
        ctx = fused_attention(q, k, v, causal=True,
                              sm_scale=1.0 / math.sqrt(hd), **drop)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, np_ * hd)
        return self.dense(ctx)

    def _scores_path(self, q, k, v, generator):
        """Scores → fused scale-mask softmax → dropout → context, on
        ``[s, b, np, hd]`` q/k/v; returns the ``[s, b, np*hd]`` context."""
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
        probs = self.scale_mask_softmax(scores.reshape(b, np_, s, s), None)
        probs = train_dropout(generator, probs, self.cfg.attention_dropout)
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
    dropout masks and the attention seed."""

    def __init__(self, cfg, device, generator, layer_number=1):
        super().__init__()
        self.cfg = cfg
        ln = dict(eps=cfg.layernorm_epsilon, device=device)
        self.input_layernorm = FusedLayerNorm(cfg.hidden_size, **ln)
        self.self_attention = ParallelAttention(cfg, device, generator,
                                                layer_number)
        self.post_attention_layernorm = FusedLayerNorm(cfg.hidden_size, **ln)
        self.mlp = ParallelMLP(cfg, device, generator)

    def forward(self, hidden, attention_mask=None, generator=None):
        cfg = self.cfg
        p, training = cfg.hidden_dropout, generator is not None
        ln_out = self.input_layernorm(hidden)
        if cfg.recompute_granularity == "selective":
            out, bias = _recomputed(
                lambda x: self.self_attention(x, attention_mask, generator),
                generator, ln_out)
        else:
            out, bias = self.self_attention(ln_out, attention_mask, generator)
        hidden = bias_dropout_add(out, bias.to(out.dtype), hidden, p,
                                  training, generator)
        out, bias = self.mlp(self.post_attention_layernorm(hidden))
        return bias_dropout_add(out, bias.to(out.dtype), hidden, p, training,
                                generator)


class ParallelTransformer(nn.Module):
    """``layer_0 .. layer_{n-1}`` and ``final_layernorm``."""

    def __init__(self, cfg, device, generator):
        super().__init__()
        self.num_layers = cfg.num_layers
        self.recompute = cfg.recompute_granularity == "full"
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}",
                            ParallelTransformerLayer(cfg, device, generator,
                                                     layer_number=i + 1))
        self.final_layernorm = FusedLayerNorm(
            cfg.hidden_size, eps=cfg.layernorm_epsilon, device=device)

    def forward(self, hidden, attention_mask=None, generator=None):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.recompute:
                hidden = _recomputed(
                    lambda x, layer=layer: layer(x, attention_mask,
                                                 generator),
                    generator, hidden)
            else:
                hidden = layer(hidden, attention_mask, generator)
        return self.final_layernorm(hidden)


class Embedding(nn.Module):
    """Position table and the word + position sum (the word table is
    owned by the model and passed in, as in the JAX package)."""

    def __init__(self, cfg, device, generator):
        super().__init__()
        self.cfg = cfg
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size,
            dtype=cfg.params_dtype, device=device).normal_(
                0.0, cfg.init_method_std, generator=generator))

    def forward(self, word_embeddings, input_ids, position_ids,
                generator=None):
        cfg = self.cfg
        emb = (vocab_parallel_embed(word_embeddings, input_ids)
               + self.position_embeddings[position_ids])
        emb = emb.transpose(0, 1)                     # [b, s, h] → [s, b, h]
        if cfg.compute_in_float16:
            emb = emb.to(cfg.compute_dtype)
        emb = emb.contiguous()
        if generator is not None and cfg.hidden_dropout > 0.0:
            emb = train_dropout(generator, emb, cfg.hidden_dropout)
        return emb


class GPTModel(nn.Module):
    """GPT language model, at tensor-parallel size ``tp_size`` (which must
    be the size :mod:`..parallel_state` was initialized with; 1 without).

    ``forward(input_ids, position_ids, attention_mask=None, labels=None,
    deterministic=True, dropout_generator=None)``: ids and positions ``[b,
    s]``; ``deterministic=False`` trains with the configuration's hidden
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
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self.cfg = cfg
        self.word_embeddings = nn.Parameter(_sharded_init(
            (cfg.vocab_size, cfg.hidden_size), 0, cfg.init_method_std,
            cfg.params_dtype, device, gen))
        self.embedding = Embedding(cfg, device, gen)
        self.transformer = ParallelTransformer(cfg, device, gen)

    def forward(self, input_ids, position_ids, attention_mask=None,
                labels=None, deterministic=True, dropout_generator=None):
        cfg = self.cfg
        gen = None
        if not deterministic and (cfg.hidden_dropout > 0
                                  or cfg.attention_dropout > 0):
            if dropout_generator is None:
                raise ValueError("GPTModel: training with dropout "
                                 "(deterministic=False) needs a "
                                 "dropout_generator")
            gen = dropout_generator
        hidden = self.embedding(self.word_embeddings, input_ids, position_ids,
                                gen)
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
