"""Fused Adam / AdamW (counterpart of ``apex_tpu/optimizers/fused_adam.py``).

:func:`fused_adam` returns an ``(init, update)`` pair over dicts of
tensors keyed by parameter name (``model.named_parameters()``), as the
JAX package's optax transformation works over the parameter pytree. The
state, :class:`FusedAdamState`, holds the int32 step count and fp32
``m`` and ``v`` per parameter. :func:`_adam_flat` is the JAX function
of the same name op for op, in fp32 per leaf: ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g g``, ``update = (m / bc1) / (sqrt(v / bc2) +
eps)`` with ``bc = 1 - b ** t``, decoupled weight decay in AdamW mode,
and ``-lr * update`` cast to the gradient's dtype. It is plain PyTorch:
``torch._foreach_*`` ops, one launch per op over every leaf. It is not
``torch.optim.Adam``, whose rounding order differs.
"""

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch._tree import flatten_tree


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

        def flat(tree):
            return {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device) for n, a in flatten_tree(tree).items()}

        return cls(torch.tensor(np.int32(count), device=device), flat(m),
                   flat(v))


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


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
    """Fused Adam as ``(init, update)``: ``init(params)`` → a zero state
    on the parameters' device; ``update(grads, state, params)`` →
    ``(updates, new_state)`` with ``updates`` keyed like ``grads``.
    ``learning_rate`` is a float or a schedule of the new step count."""
    beta1, beta2 = betas

    def init(params):
        device = next(iter(params.values())).device
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                 for n, p in params.items()}
        return FusedAdamState(
            torch.zeros((), dtype=torch.int32, device=device), zeros,
            {n: z.clone() for n, z in zeros.items()})

    def update(grads, state, params):
        names = list(grads)
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) \
            else learning_rate
        us, ms, vs = _adam_flat(
            [grads[n].float() for n in names],
            [params[n].float() for n in names],
            [state.m[n] for n in names], [state.v[n] for n in names],
            count, lr, beta1, beta2, eps, weight_decay, adam_w_mode,
            bias_correction)
        updates = {n: u.to(grads[n].dtype) for n, u in zip(names, us)}
        return updates, FusedAdamState(count, dict(zip(names, ms)),
                                       dict(zip(names, vs)))

    return GradientTransformation(init, update)
