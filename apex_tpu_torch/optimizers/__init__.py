"""Fused optimizers (counterpart of ``apex_tpu.optimizers``): each as a
transform over dicts of tensors (``fused_adam(...)``: ``init``,
``update`` and, for Adam and LAMB, the in-place fused ``step`` on the
multi-tensor kernels) and as a ``torch.optim.Optimizer`` class
(``FusedAdam``)."""

from apex_tpu_torch.optimizers._base import grad_norm_stats
from apex_tpu_torch.optimizers.fused_adam import (FusedAdam, FusedAdamState,
                                                  fused_adam)
from apex_tpu_torch.optimizers.fused_sgd import (FusedSGD, FusedSGDState,
                                                 fused_sgd)
from apex_tpu_torch.optimizers.fused_lamb import (FusedLAMB, FusedLAMBState,
                                                  fused_lamb)
from apex_tpu_torch.optimizers.fused_novograd import (
    FusedNovoGrad, FusedNovoGradState, fused_novograd,
)
from apex_tpu_torch.optimizers.fused_adagrad import (
    FusedAdagrad, FusedAdagradState, fused_adagrad,
)
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb, fused_mixed_precision_lamb,
)

__all__ = [
    "FusedAdam", "fused_adam", "FusedAdamState",
    "FusedSGD", "fused_sgd", "FusedSGDState",
    "FusedLAMB", "fused_lamb", "FusedLAMBState",
    "FusedNovoGrad", "fused_novograd", "FusedNovoGradState",
    "FusedAdagrad", "fused_adagrad", "FusedAdagradState",
    "FusedMixedPrecisionLamb", "fused_mixed_precision_lamb",
    "grad_norm_stats",
]
