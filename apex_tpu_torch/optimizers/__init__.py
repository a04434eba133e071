"""Optimizers (counterpart of ``apex_tpu.optimizers``): fused Adam."""

from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdamState,
    fused_adam,
)
