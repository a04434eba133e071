"""Standalone model definitions (counterpart of
``apex_tpu.transformer.testing``)."""

from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (  # noqa: F401
    GPTModel,
    TransformerConfig,
)
