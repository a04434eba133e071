"""Mixed precision (counterpart of ``apex_tpu.amp``): dynamic loss
scaling on device tensors."""

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState  # noqa: F401
