"""Transformer runtime (counterpart of ``apex_tpu.transformer``):
``parallel_state`` (the tensor-parallel groups on torch.distributed),
``tensor_parallel``, ``amp`` (the model-parallel ``GradScaler``),
``functional`` (the fused softmax), ``utils``, ``enums`` and ``testing``
(the standalone GPT and BERT)."""

from apex_tpu_torch.transformer import parallel_state  # noqa: F401
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
