"""Standalone model definitions (counterpart of
``apex_tpu.transformer.testing``): GPT, BERT and the language model."""

from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (  # noqa: F401
    BertLMHead,
    BertModel,
    Embedding,
    GPTModel,
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    Pooler,
    TransformerConfig,
    TransformerLanguageModel,
    bert_extended_attention_mask,
    bert_model_provider,
    bert_position_ids,
    get_language_model,
    parallel_lm_logits,
)
