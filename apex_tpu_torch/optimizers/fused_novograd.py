"""Fused NovoGrad (counterpart of ``apex_tpu/optimizers/fused_novograd.py``).

JAX's update: ``v`` holds each tensor's gradient norm (not its square),
blended as ``sqrt(b2 v^2 + (1 - b2) |g|^2)`` (``norm_type`` 2) or ``b2 v +
(1 - b2) max|g|`` (0), initialized with the first step's norm unless
``init_zero``; ``bc2 = sqrt(1 - b2^t)``; ``denom = v / bc2 + eps``;
``reg_inside_moment`` (MOMENT_MODE_0) puts the decay inside the moment,
else it is added to the update. The state, :class:`FusedNovoGradState`,
is the count, an fp32 ``m`` per parameter and ``v`` a ``[num_tensors]``
vector in the order of ``m``'s names. Plain PyTorch: JAX computes it in
jnp, and its CUDA kernel is still to come (ROADMAP).
"""

import dataclasses

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             GradientTransformation,
                                             count_from_numpy,
                                             tensors_from_numpy)


@dataclasses.dataclass
class FusedNovoGradState:
    count: torch.Tensor  # 0-d int32 step count
    m: dict              # name -> fp32 first moment
    v: torch.Tensor      # [num_tensors] fp32 gradient norms, m's order

    @classmethod
    def from_numpy(cls, count, m, v, device=None):
        """A state from host arrays: ``m`` a nested dict keyed like the JAX
        parameter tree, ``v`` the per-tensor vector in its leaf order;
        ``device=None`` means ``cuda``."""
        device = default_device(device)
        return cls(count_from_numpy(count, device),
                   tensors_from_numpy(m, device),
                   torch.from_numpy(np.array(v, dtype=np.float32)).to(device))


def fused_novograd(learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=0.0, grad_averaging=True, init_zero=False,
                   reg_inside_moment=False, norm_type=2, bias_correction=True):
    """Fused NovoGrad as ``(init, update)`` over dicts of tensors keyed by
    name."""
    beta1, beta2 = betas
    if norm_type not in (0, 2):
        raise RuntimeError("FusedNovoGrad only support l2/inf norm now.")
    beta3 = 1.0 - beta1 if grad_averaging else 1.0

    def init(params):
        device = next(iter(params.values())).device
        return FusedNovoGradState(
            torch.zeros((), dtype=torch.int32, device=device),
            {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()},
            torch.zeros(len(params), dtype=torch.float32, device=device))

    def update(grads, state, params):
        names = list(state.m)
        count = state.count + 1
        t = count.float()
        lr = learning_rate(count) if callable(learning_rate) \
            else learning_rate
        neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
        if not names:
            return {}, FusedNovoGradState(count, state.m, state.v)
        gs = [grads[n].float() for n in names]
        if norm_type == 2:
            step_norm = torch.stack([torch.sqrt(torch.sum(g * g))
                                     for g in gs])
        else:
            step_norm = torch.stack([torch.max(torch.abs(g)) for g in gs])
        v_prev = state.v if init_zero else torch.where(count == 1, step_norm,
                                                       state.v)
        if norm_type == 2:
            v = torch.sqrt(beta2 * v_prev * v_prev
                           + (1.0 - beta2) * step_norm ** 2)
        else:
            v = beta2 * v_prev + (1.0 - beta2) * step_norm
        if bias_correction:
            bc1 = 1.0 - torch.pow(beta1, t)
            bc2 = torch.sqrt(1.0 - torch.pow(beta2, t))
        else:
            bc1 = bc2 = 1.0
        updates, ms = {}, {}
        for i, (n, g) in enumerate(zip(names, gs)):
            p = params[n].float()
            m = state.m[n]
            denom = v[i] / bc2 + eps
            if reg_inside_moment:
                m = beta1 * m + beta3 * (g / denom + weight_decay * p)
                u = neg_lr * m / bc1
            else:
                m = beta1 * m + beta3 * g
                u = neg_lr * ((m / bc1) / denom + weight_decay * p)
            updates[n] = u.to(grads[n].dtype)
            ms[n] = m
        return updates, FusedNovoGradState(count, ms, v)

    return GradientTransformation(init, update)


class FusedNovoGrad(FusedOptimizerBase):
    """The class surface (apex's ``FusedNovoGrad``); ``amsgrad`` raises."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, amsgrad=False,
                 reg_inside_moment=False, grad_averaging=True, norm_type=2,
                 init_zero=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad variant.")
        super().__init__(params, dict(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging))
        self.reg_inside_moment = reg_inside_moment
        self.norm_type = norm_type
        self.init_zero = init_zero

    def _group_tx(self, group):
        return fused_novograd(
            learning_rate=group["lr"], betas=group["betas"], eps=group["eps"],
            weight_decay=group["weight_decay"],
            grad_averaging=group["grad_averaging"],
            init_zero=self.init_zero, reg_inside_moment=self.reg_inside_moment,
            norm_type=self.norm_type, bias_correction=group["bias_correction"])
