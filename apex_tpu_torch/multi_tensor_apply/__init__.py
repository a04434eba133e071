"""Multi-tensor ops (counterpart of ``apex_tpu.multi_tensor_apply``)."""

from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (
    MultiTensorApply,
    multi_tensor_applier,
    flatten,
    unflatten,
    multi_tensor_scale,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_l2norm_per_tensor,
)

__all__ = [
    "MultiTensorApply",
    "multi_tensor_applier",
    "flatten",
    "unflatten",
    "multi_tensor_scale",
    "multi_tensor_axpby",
    "multi_tensor_l2norm",
    "multi_tensor_l2norm_per_tensor",
]
