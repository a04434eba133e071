"""LARC: layer-wise adaptive rate clipping and scaling (counterpart of
``apex_tpu/parallel/LARC.py``).

Each tensor's adaptive rate is ``trust_coefficient * |p| / (|g| + wd *
|p| + eps)``; in clip mode it is ``min(rate / lr, 1)``. Where both norms
are positive the gradient becomes ``rate * (g + wd * p)``; a tensor with
a zero norm passes through unchanged (no rate, no decay). Two surfaces,
as JAX's: :func:`larc`, a transform to run before an optimizer's (its
``update`` maps gradients to gradients, JAX's ``optax.chain(larc(...),
inner)``), and the :class:`LARC` class, which wraps an optimizer of the
port's classes (``FusedSGD`` and the others over ``param_groups``).

The per-tensor norms are :func:`apex_tpu_torch.ops.multi_tensor.l2norm`'s:
K13 on the card (one fixed-order pass over the list), the plain
per-tensor sums on the CPU. The arithmetic is fp32, and each gradient
comes back in its dtype.
"""

import torch

from apex_tpu_torch import device_scalar
from apex_tpu_torch.ops import multi_tensor
from apex_tpu_torch.optimizers._base import GradientTransformation


def larc(trust_coefficient=0.02, clip=True, eps=1e-8, weight_decay=0.0,
         learning_rate=None):
    """LARC's gradient transform; ``update(grads, state, params)`` returns
    ``(scaled grads, state)`` keyed like ``grads``. Clip mode needs the
    group's ``learning_rate``."""
    if clip and learning_rate is None:
        raise ValueError("clip mode needs the group learning_rate")

    def init(params):
        del params
        return None

    @torch.no_grad()
    def update(grads, state, params):
        names = list(grads)
        if not names:
            return {}, state
        gs = [grads[n].float() for n in names]
        ps = [params[n].float() for n in names]
        p_norm = multi_tensor.l2norm(ps).per_tensor
        g_norm = multi_tensor.l2norm(gs).per_tensor
        adaptive = trust_coefficient * p_norm / (
            g_norm + weight_decay * p_norm + eps)
        if clip:
            adaptive = torch.clamp(
                adaptive / device_scalar(learning_rate, adaptive), max=1.0)
        valid = (p_norm > 0) & (g_norm > 0)
        adaptive = torch.where(valid, adaptive, 1.0)
        out = {}
        for i, n in enumerate(names):
            g = gs[i]
            if weight_decay != 0:
                g = g + weight_decay * ps[i] * valid[i].to(g.dtype)
            out[n] = (adaptive[i] * g).to(grads[n].dtype)
        return out, state

    return GradientTransformation(init, update)


class LARC:
    """``LARC(optimizer, trust_coefficient=0.02, clip=True, eps=1e-8)``:
    :meth:`step` scales each group's gradients (each parameter's
    ``grad``, or the lists given) by :func:`larc` with the group's
    ``lr`` and ``weight_decay``, then steps the wrapped optimizer with
    the group's weight decay set to 0 (LARC has applied it), and restores
    it."""

    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def state(self):
        return self.optim.state

    @torch.no_grad()
    def step(self, grads=None, closure=None):
        """``grads``: None (read ``p.grad``), a list of tensors (one
        group), or a list of such lists (one a group)."""
        groups = self.optim.param_groups
        if grads is not None and len(groups) == 1 and (
                not grads or not isinstance(grads[0], (list, tuple))):
            grads = [grads]
        for i, group in enumerate(groups):
            ps = {str(j): p for j, p in enumerate(group["params"])}
            if grads is None:
                gs = {n: p.grad for n, p in ps.items() if p.grad is not None}
                ps = {n: ps[n] for n in gs}
            else:
                gs = dict(zip(ps, grads[i]))
            tx = larc(self.trust_coefficient, self.clip, self.eps,
                      weight_decay=group.get("weight_decay", 0.0),
                      learning_rate=group["lr"])
            scaled, _ = tx.update(gs, None, ps)
            for n, g in scaled.items():
                ps[n].grad = g
        saved = [g.get("weight_decay") for g in groups]
        for g in groups:
            if "weight_decay" in g:
                g["weight_decay"] = 0.0
        try:
            return self.optim.step(closure)
        finally:
            for g, wd in zip(groups, saved):
                if wd is not None:
                    g["weight_decay"] = wd

    def zero_grad(self, set_to_none=True):
        self.optim.zero_grad(set_to_none)
