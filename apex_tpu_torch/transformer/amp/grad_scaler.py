"""The model-parallel grad scaler (counterpart of
``apex_tpu/transformer/amp/grad_scaler.py``).

:class:`GradScaler` is :class:`apex_tpu_torch.amp.LossScaler` with
``torch.cuda.amp.GradScaler``'s constructor, whose :meth:`unscale`
all-reduces the overflow flag with MAX over the tensor-parallel group
(the JAX ``pmax`` of ``:54-59``): a rank whose shard overflowed skips the
step, and so does every other rank of its group, so the shards stay one
model. The flag stays a device tensor (reduced as fp32 0/1), so the step
still waits on no ``.item()``. ``group`` (JAX's ``axis_names``) names
another group: the data-parallel group of the ZeRO optimizers, whose
ranks must skip together because every rank runs their collectives.
"""

import dataclasses

import torch
import torch.distributed as dist

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce_


@dataclasses.dataclass(frozen=True)
class GradScaler(LossScaler):
    """``(init_scale, growth_factor, backoff_factor, growth_interval)``
    map onto LossScaler's ``init_scale``, ``scale_factor``,
    ``backoff_factor``, ``scale_window``; ``group`` is the group whose
    ranks share the flag (None: :mod:`..parallel_state`'s tp group)."""

    group: object = None

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000, enabled=True,
                 group=None):
        if not growth_factor > 1.0:
            raise ValueError("The growth factor must be > 1.0.")
        if not 0.0 < backoff_factor < 1.0:
            raise ValueError("The backoff factor must be < 1.0.")
        for name, value in (("loss_scale", "dynamic" if enabled else 1.0),
                            ("init_scale", init_scale),
                            ("scale_factor", growth_factor),
                            ("backoff_factor", backoff_factor),
                            ("scale_window", growth_interval),
                            ("min_loss_scale", None),
                            ("max_loss_scale", 2.0 ** 24),
                            ("group", group)):
            object.__setattr__(self, name, value)

    def unscale(self, grads, state):
        grads, found_inf = super().unscale(grads, state)
        flag = all_reduce_(found_inf.to(torch.float32, copy=True),
                           group=self.group, op=dist.ReduceOp.MAX)
        return grads, flag > 0
