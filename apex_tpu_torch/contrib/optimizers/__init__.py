"""apex's contrib optimizers (counterpart of
``apex_tpu.contrib.optimizers``): the ZeRO-2 sharded optimizers
:class:`DistributedFusedAdam` / :func:`distributed_fused_adam` and
:class:`DistributedFusedLAMB` / :func:`distributed_fused_lamb`, and the
compat aliases of the earlier fused optimizers, ``FusedAdam``,
``FusedLAMB``, ``FusedSGD`` and ``FP16_Optimizer``, exported as JAX's
module exports them."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (  # noqa: F401
    DistAdamState,
    DistributedFusedAdam,
    distributed_fused_adam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (  # noqa: F401
    DistLambState,
    DistributedFusedLAMB,
    distributed_fused_lamb,
)
from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB  # noqa: F401
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
