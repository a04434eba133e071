"""Mixed precision (counterpart of ``apex_tpu.amp``): opt levels and
``initialize`` (``frontend.py``), dtype policies and cast combinators
(``policy.py``), master weights and the skip step (``AmpOptimizer``),
loss scaling on device tensors (``LossScaler``) and the handle
(``value_and_scaled_grad``, ``scale_loss``). JAX's ``__all__``."""

from apex_tpu_torch.amp.frontend import (Properties, build_policy,
                                         initialize, load_state_dict,
                                         opt_levels, state_dict)
from apex_tpu_torch.amp._amp_state import master_params
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.amp.amp_optimizer import AmpOptimizer, AmpOptState
from apex_tpu_torch.amp.handle import (AmpHandle, NoOpHandle, disable_casts,
                                       init, scale_loss,
                                       value_and_scaled_grad)
from apex_tpu_torch.amp.policy import (BANNED_FUNCS, CASTS, FP16_FUNCS,
                                       FP32_FUNCS, SEQUENCE_CASTS, Policy,
                                       autocast, cast_for_op, compute_dtype,
                                       current_policy, float_function,
                                       half_function, lookup_cast,
                                       promote_function,
                                       register_float_function,
                                       register_half_function,
                                       register_promote_function)
from apex_tpu_torch.amp import _amp_state  # noqa: F401

__all__ = [
    "initialize", "state_dict", "load_state_dict", "opt_levels", "Properties",
    "build_policy", "LossScaler", "LossScalerState", "AmpOptimizer",
    "AmpOptState", "scale_loss", "value_and_scaled_grad", "disable_casts",
    "AmpHandle", "NoOpHandle", "init", "master_params",
    "Policy", "autocast", "current_policy", "compute_dtype", "half_function",
    "float_function", "promote_function", "register_half_function",
    "register_float_function", "register_promote_function", "cast_for_op",
    "lookup_cast",
]
