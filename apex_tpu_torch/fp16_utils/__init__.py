"""apex's legacy manual mixed-precision helpers (counterpart of
``apex_tpu.fp16_utils``; deprecated in apex in favour of amp and kept for
its API). The helpers work on dicts of tensors keyed by parameter name
(the port's parameter trees; a module's ``named_parameters``) and on
``nn.Module``s, cast in place. Plain PyTorch: there is no kernel here."""

from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    BN_convert_float,
    FP16Model,
    clip_grad_norm,
    convert_module,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
    tofp16,
)
from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer  # noqa: F401
from apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaler,
)
