"""Tensor-parallel layers, mappings and the vocab-parallel cross entropy
(counterpart of ``apex_tpu.transformer.tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    vocab_parallel_embed,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.utils import (  # noqa: F401
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)
