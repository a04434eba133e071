"""Fused LAMB (counterpart of ``apex_tpu/optimizers/fused_lamb.py``).

The update is JAX's: the gradients clipped by their global norm
(``max(||g|| / max_grad_norm, 1)``), Adam's moments and direction
(MOMENT_MODE_0 folds the decay into the gradient, MODE_1, ``adam_w_mode``,
adds it to the direction), and a per-tensor trust ratio ``||p|| / ||u||``
(1 where either is 0, and everywhere when ``weight_decay`` is 0 and not
``use_nvlamb``) on ``-lr * ratio * u``. The state, :class:`FusedLAMBState`,
is Adam's: the count and fp32 ``m``, ``v`` per parameter.

``impl=`` picks the plain version's structure, as in JAX: ``"two_pass"``
(per leaf: the global norm as the sum of the leaves' sums in leaf order,
then each leaf's update and norms) or ``"one_pass"`` (one flat buffer:
its sum of squares, per-tensor norms as one segment sum). An explicit
``impl`` outside those raises; unset, ``APEX_LAMB_IMPL`` is the
preference and raises on an unknown value, as JAX's does; unset both, it
is ``"two_pass"``, the seat JAX takes when its dispatch table has no
entry (the port has no dispatch table yet).

On the card, ``step`` (the in-place fused form ``train_step`` calls)
serves both structures with the same kernels and one fixed reduction
order: K13 (``ops/multi_tensor_cuda.l2norm``) sums each gradient's
squares and then the tensors in order; K15 (``multi_tensor_cuda.lamb``)
clips, updates the moments and sums each chunk's squares of p and of the
direction, then sums a tensor's chunks in order for its ratio and writes
p; two runs give the same bits. It writes nothing where the found-inf
flag is set. On the CPU ``step`` is the plain form over ``update``.
"""

import dataclasses
import os

import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             GradientTransformation,
                                             apply_plain, copy_into,
                                             count_from_numpy,
                                             tensors_from_numpy)
from apex_tpu_torch.optimizers._fused import get_meta

_IMPLS = ("two_pass", "one_pass")


@dataclasses.dataclass
class FusedLAMBState:
    count: torch.Tensor  # 0-d int32 step count
    m: dict              # name -> fp32 first moment
    v: dict              # name -> fp32 second moment

    @classmethod
    def from_numpy(cls, count, m, v, device=None):
        """A state from host arrays (``m``, ``v`` nested dicts keyed like
        the JAX parameter tree); ``device=None`` means ``cuda``."""
        device = default_device(device)
        return cls(count_from_numpy(count, device),
                   tensors_from_numpy(m, device),
                   tensors_from_numpy(v, device))


def _resolve_impl(impl):
    """The structure: an explicit ``impl`` (raises on an unknown one), else
    ``APEX_LAMB_IMPL`` (raises on an unknown one), else ``"two_pass"``."""
    if impl is not None:
        if impl not in _IMPLS:
            raise ValueError(f"fused_lamb impl={impl!r}: want one of {_IMPLS}")
        return impl
    env = os.environ.get("APEX_LAMB_IMPL")
    if env in _IMPLS:
        return env
    if env:
        raise ValueError(f"APEX_LAMB_IMPL={env!r}: want one of {_IMPLS}")
    return "two_pass"


def fused_lamb(learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-6,
               weight_decay=0.01, bias_correction=True, adam_w_mode=True,
               grad_averaging=True, max_grad_norm=1.0, use_nvlamb=False,
               impl=None):
    """Fused LAMB as ``(init, update, step)`` over dicts of tensors keyed
    by name; ``learning_rate`` a float or a schedule of the new step count
    (a 0-d int32 tensor on the device)."""
    beta1, beta2 = betas
    impl = _resolve_impl(impl)
    beta3 = 1.0 - beta1 if grad_averaging else 1.0
    clipping = max_grad_norm is not None and max_grad_norm > 0
    trust = weight_decay != 0.0 or use_nvlamb

    def init(params):
        device = next(iter(params.values())).device
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
        return FusedLAMBState(
            torch.zeros((), dtype=torch.int32, device=device), zeros,
            {n: z.clone() for n, z in zeros.items()})

    def _hyper(count):
        lr = learning_rate(count) if callable(learning_rate) \
            else learning_rate
        if not bias_correction:
            return lr, None, None
        t = count.float()
        return lr, 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)

    def _moments(g, p, m, v):
        g_eff = g if adam_w_mode else g + weight_decay * p
        return beta1 * m + beta3 * g_eff, beta2 * v + (1.0 - beta2) * g_eff \
            * g_eff

    def _direction(m, v, p, bc1, bc2):
        if bc1 is None:
            upd = m / (torch.sqrt(v) + eps)
        else:
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return upd + weight_decay * p if adam_w_mode else upd

    def _ratio(w_norm, u_norm):
        ratio = torch.where((w_norm > 0) & (u_norm > 0),
                            w_norm / (u_norm + 1e-38), 1.0)
        return ratio if trust else torch.ones_like(ratio)

    def _neg(lr):
        return lr.neg() if torch.is_tensor(lr) else -lr

    def update_two_pass(gs, ps, ms, vs, count):
        lr, bc1, bc2 = _hyper(count)
        if clipping:
            global_sq = sum(torch.sum(g * g) for g in gs)
            clip = torch.clamp(torch.sqrt(global_sq) / max_grad_norm, min=1.0)
            gs = [g / clip for g in gs]
        us, new_m, new_v = [], [], []
        for g, p, m, v in zip(gs, ps, ms, vs):
            m, v = _moments(g, p, m, v)
            upd = _direction(m, v, p, bc1, bc2)
            ratio = _ratio(torch.sqrt(torch.sum(p * p)),
                           torch.sqrt(torch.sum(upd * upd)))
            us.append(_neg(lr) * ratio * upd)
            new_m.append(m)
            new_v.append(v)
        return us, new_m, new_v

    def update_one_pass(gs, ps, ms, vs, count):
        lr, bc1, bc2 = _hyper(count)
        meta = get_meta(ps)
        g_flat, p_flat = meta.flatten(gs), meta.flatten(ps)
        m_flat, v_flat = meta.flatten(ms), meta.flatten(vs)
        if clipping:
            clip = torch.clamp(torch.sqrt(torch.sum(g_flat * g_flat))
                               / max_grad_norm, min=1.0)
            g_flat = g_flat / clip
        m_flat, v_flat = _moments(g_flat, p_flat, m_flat, v_flat)
        upd = _direction(m_flat, v_flat, p_flat, bc1, bc2)
        ratio = _ratio(torch.sqrt(meta.per_tensor_sq_norms(p_flat)),
                       torch.sqrt(meta.per_tensor_sq_norms(upd)))
        u_flat = _neg(lr) * meta.broadcast_per_tensor(ratio) * upd
        fp32 = [torch.float32] * meta.num_tensors
        return (meta.unflatten(u_flat, fp32), meta.unflatten(m_flat, fp32),
                meta.unflatten(v_flat, fp32))

    def update(grads, state, params):
        names = list(grads)
        count = state.count + 1
        fn = update_one_pass if impl == "one_pass" else update_two_pass
        us, ms, vs = fn([grads[n].float() for n in names],
                        [params[n].float() for n in names],
                        [state.m[n] for n in names],
                        [state.v[n] for n in names], count)
        updates = {n: u.to(grads[n].dtype) for n, u in zip(names, us)}
        return updates, FusedLAMBState(count, dict(zip(names, ms)),
                                       dict(zip(names, vs)))

    def step(grads, state, params, found_inf=None, model_params=None):
        names = list(grads)
        if not names or not grads[names[0]].is_cuda:
            apply_plain(update, grads, state, params, found_inf)
            copy_into(params, model_params)
            return state
        from apex_tpu_torch.ops import multi_tensor_cuda

        count = state.count + 1
        lr, bc1, bc2 = _hyper(count)
        gs = [grads[n] for n in names]
        global_sq = multi_tensor_cuda.l2norm(gs).total_sq if clipping \
            else None
        multi_tensor_cuda.lamb(
            gs, [params[n] for n in names], [state.m[n] for n in names],
            [state.v[n] for n in names], state.count, count, bc1, bc2, lr,
            beta1=beta1, beta2=beta2, beta3=beta3, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode,
            bias_correction=bias_correction, max_grad_norm=max_grad_norm,
            trust=trust, global_sq=global_sq, skip=found_inf)
        copy_into(params, model_params)
        return state

    return GradientTransformation(init, update, step)


class FusedLAMB(FusedOptimizerBase):
    """The class surface (apex's ``FusedLAMB``); ``amsgrad`` raises."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad variant.")
        super().__init__(params, dict(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            max_grad_norm=max_grad_norm))
        self.adam_w_mode = adam_w_mode
        self.use_nvlamb = use_nvlamb

    def _group_tx(self, group):
        return fused_lamb(
            learning_rate=group["lr"], betas=group["betas"], eps=group["eps"],
            weight_decay=group["weight_decay"],
            bias_correction=group["bias_correction"],
            adam_w_mode=self.adam_w_mode,
            grad_averaging=group["grad_averaging"],
            max_grad_norm=group["max_grad_norm"], use_nvlamb=self.use_nvlamb)
