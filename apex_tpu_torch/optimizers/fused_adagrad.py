"""Fused Adagrad (counterpart of ``apex_tpu/optimizers/fused_adagrad.py``).

JAX's update: ``s += g^2``, ``u = g / (sqrt(s) + eps)``, the decay folded
into the gradient or, with ``adagrad_w_mode``, added to ``u``, and ``-lr
u`` cast to the gradient's dtype. The state, :class:`FusedAdagradState`,
is the count and an fp32 ``sum_sq`` per parameter. Plain PyTorch: JAX
computes it in jnp, and its CUDA kernel is still to come (ROADMAP).
"""

import dataclasses

import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             GradientTransformation,
                                             count_from_numpy,
                                             tensors_from_numpy)


@dataclasses.dataclass
class FusedAdagradState:
    count: torch.Tensor  # 0-d int32 step count
    sum_sq: dict         # name -> fp32 sum of squared gradients

    @classmethod
    def from_numpy(cls, count, sum_sq, device=None):
        """A state from host arrays (``sum_sq`` a nested dict keyed like
        the JAX parameter tree); ``device=None`` means ``cuda``."""
        device = default_device(device)
        return cls(count_from_numpy(count, device),
                   tensors_from_numpy(sum_sq, device))


def fused_adagrad(learning_rate=1e-2, eps=1e-10, weight_decay=0.0,
                  adagrad_w_mode=False):
    """Fused Adagrad as ``(init, update)`` over dicts of tensors keyed by
    name."""

    def init(params):
        device = next(iter(params.values())).device
        return FusedAdagradState(
            torch.zeros((), dtype=torch.int32, device=device),
            {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()})

    def update(grads, state, params):
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) \
            else learning_rate
        neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
        updates, sums = {}, {}
        for n, gl in grads.items():
            g = gl.float()
            p = params[n].float()
            if weight_decay != 0 and not adagrad_w_mode:
                g = g + weight_decay * p
            s = state.sum_sq[n] + g * g
            upd = g / (torch.sqrt(s) + eps)
            if weight_decay != 0 and adagrad_w_mode:
                upd = upd + weight_decay * p
            updates[n] = (neg_lr * upd).to(gl.dtype)
            sums[n] = s
        return updates, FusedAdagradState(count, sums)

    return GradientTransformation(init, update)


class FusedAdagrad(FusedOptimizerBase):
    """The class surface (apex's ``FusedAdagrad``)."""

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay))
        self.adagrad_w_mode = adagrad_w_mode

    def _group_tx(self, group):
        return fused_adagrad(learning_rate=group["lr"], eps=group["eps"],
                             weight_decay=group["weight_decay"],
                             adagrad_w_mode=self.adagrad_w_mode)
