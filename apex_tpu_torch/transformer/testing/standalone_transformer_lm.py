"""Model configuration of the standalone GPT (counterpart of
``apex_tpu/transformer/testing/standalone_transformer_lm.py``).

Only :class:`TransformerConfig` is ported so far: the serving path reads
its shape and numerics fields. The fields keep the JAX package's names
and defaults, so one set of keyword arguments builds the same
configuration on either side. ``GPTModel`` itself comes with the
training step.
"""

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Shape and numerics options of the GPT model (the serving subset of
    the JAX package's ``TransformerConfig``, same defaults)."""

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
    apply_query_key_layer_scaling: bool = True
    sequence_parallel: bool = False
    context_parallel_axis: Optional[str] = None
    num_moe_experts: Optional[int] = None
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
