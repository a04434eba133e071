"""Fused Adam / AdamW (counterpart of ``apex_tpu/optimizers/fused_adam.py``).

:func:`fused_adam` returns a :class:`~apex_tpu_torch.optimizers._base.
GradientTransformation` over dicts of tensors keyed by parameter name
(``model.named_parameters()``), as the JAX package's optax transformation
works over the parameter pytree. The state, :class:`FusedAdamState`,
holds the int32 step count and fp32 ``m`` and ``v`` per parameter.
:func:`_adam_flat` is the JAX function of the same name op for op, in
fp32 per leaf: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
``update = (m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc = 1 - b ** t``,
decoupled weight decay in AdamW mode, and ``-lr * update`` cast to the
gradient's dtype. It is plain PyTorch: ``torch._foreach_*`` ops, one
launch per op over every leaf. It is not ``torch.optim.Adam``, whose
rounding order differs.

``step`` is the in-place fused form ``train_step`` calls: on CUDA
tensors one K14 launch a group of leaves (``csrc/multi_tensor.cu``,
``ops/multi_tensor_cuda.adam``) writes p, m, v and the count in the same
fp32 order, so it equals the plain form bit for bit; where the found-inf
flag is set it writes nothing. On the CPU it is the plain form,
:func:`~apex_tpu_torch.optimizers._base.apply_plain` over ``update``.
:class:`FusedAdam` is the class surface.
"""

import dataclasses

import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             GradientTransformation,
                                             apply_plain, copy_into,
                                             count_from_numpy,
                                             tensors_from_numpy)

__all__ = ["FusedAdam", "FusedAdamState", "GradientTransformation",
           "fused_adam"]


@dataclasses.dataclass
class FusedAdamState:
    count: torch.Tensor  # 0-d int32 step count
    m: dict              # name -> fp32 exp_avg
    v: dict              # name -> fp32 exp_avg_sq

    @classmethod
    def from_numpy(cls, count, m, v, device=None):
        """A state from host arrays: ``m`` and ``v`` are nested dicts
        keyed like the JAX parameter tree (flattened here with ``.``, the
        port's parameter names); ``device=None`` means ``cuda``."""
        device = default_device(device)
        return cls(count_from_numpy(count, device),
                   tensors_from_numpy(m, device),
                   tensors_from_numpy(v, device))


def _zeros_like_params(params):
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _count_like(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _adam_flat(g, p, m, v, count, lr, beta1, beta2, eps, weight_decay,
               adam_w_mode, bias_correction):
    """The AdamFunctor math over lists of fp32 leaves; returns the lists
    ``(-lr * update, m, v)``. The decay terms are skipped when
    ``weight_decay`` is 0, which is bit-identical to adding ``0 * p``."""
    t = count.float()
    if not adam_w_mode and weight_decay:
        g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
    m = torch._foreach_add(torch._foreach_mul(m, beta1),
                           torch._foreach_mul(g, 1.0 - beta1))
    v = torch._foreach_add(
        torch._foreach_mul(v, beta2),
        torch._foreach_mul(torch._foreach_mul(g, 1.0 - beta2), g))
    if bias_correction:
        bc1 = 1.0 - torch.pow(beta1, t)
        bc2 = 1.0 - torch.pow(beta2, t)
        update = torch._foreach_div(
            torch._foreach_div(m, bc1),
            torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)),
                               eps))
    else:
        update = torch._foreach_div(
            m, torch._foreach_add(torch._foreach_sqrt(v), eps))
    if adam_w_mode and weight_decay:
        update = torch._foreach_add(update,
                                    torch._foreach_mul(p, weight_decay))
    neg_lr = -lr if not torch.is_tensor(lr) else lr.neg()
    return torch._foreach_mul(update, neg_lr), m, v


def fused_adam(learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=0.0, adam_w_mode=True, bias_correction=True):
    """Fused Adam as ``(init, update, step)``: ``init(params)`` → a zero
    state on the parameters' device; ``update(grads, state, params)`` →
    ``(updates, new_state)`` with ``updates`` keyed like ``grads``;
    ``step(grads, state, params, found_inf=None)`` updates the parameters
    and ``state`` in place (K14 on CUDA). ``learning_rate`` is a float or
    a schedule of the new step count (a 0-d int32 tensor on the device)."""
    beta1, beta2 = betas

    def init(params):
        zeros = _zeros_like_params(params)
        return FusedAdamState(_count_like(params), zeros,
                              {n: z.clone() for n, z in zeros.items()})

    def _lr(count):
        return learning_rate(count) if callable(learning_rate) \
            else learning_rate

    def update(grads, state, params):
        names = list(grads)
        count = state.count + 1
        us, ms, vs = _adam_flat(
            [grads[n].float() for n in names],
            [params[n].float() for n in names],
            [state.m[n] for n in names], [state.v[n] for n in names],
            count, _lr(count), beta1, beta2, eps, weight_decay, adam_w_mode,
            bias_correction)
        updates = {n: u.to(grads[n].dtype) for n, u in zip(names, us)}
        return updates, FusedAdamState(count, dict(zip(names, ms)),
                                       dict(zip(names, vs)))

    def step(grads, state, params, found_inf=None, model_params=None):
        names = list(grads)
        if not names or not grads[names[0]].is_cuda:
            apply_plain(update, grads, state, params, found_inf)
            copy_into(params, model_params)
            return state
        from apex_tpu_torch.ops import multi_tensor_cuda

        count = state.count + 1
        bc1 = bc2 = None
        if bias_correction:
            t = count.float()
            bc1 = 1.0 - torch.pow(beta1, t)
            bc2 = 1.0 - torch.pow(beta2, t)
        multi_tensor_cuda.adam(
            [grads[n] for n in names], [params[n] for n in names],
            [state.m[n] for n in names], [state.v[n] for n in names],
            state.count, count, bc1, bc2, _lr(count), beta1=beta1,
            beta2=beta2, eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode, bias_correction=bias_correction,
            skip=found_inf)
        copy_into(params, model_params)
        return state

    return GradientTransformation(init, update, step)


class FusedAdam(FusedOptimizerBase):
    """The class surface (apex's ``FusedAdam``): ``params`` an iterable of
    tensors or of param-group dicts; ``step()`` reads ``p.grad`` and
    updates in place. ``capturable`` and ``master_weights`` are accepted
    and change nothing (the state is fp32 already); ``amsgrad`` raises."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 capturable=False, master_weights=False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.adam_w_mode = adam_w_mode
        self.set_grad_none = set_grad_none

    def _group_tx(self, group):
        return fused_adam(
            learning_rate=group["lr"], betas=group["betas"], eps=group["eps"],
            weight_decay=group["weight_decay"], adam_w_mode=self.adam_w_mode,
            bias_correction=group["bias_correction"])
