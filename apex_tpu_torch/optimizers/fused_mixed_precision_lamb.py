"""LAMB over half-precision parameters with fp32 masters (counterpart of
``apex_tpu/optimizers/fused_mixed_precision_lamb.py``).

The state, :class:`MixedPrecisionLambState`, holds the masters as one flat
fp32 buffer (in the order of the inner state's names) and the inner
:class:`~apex_tpu_torch.optimizers.fused_lamb.FusedLAMBState`. ``update``
steps the masters with fused LAMB on fp32 gradients and returns updates in
the model's dtype such that the new half parameters are the new masters
cast, as JAX computes them. ``step``, the in-place form, routes through
fused LAMB's: on CUDA K13 and K15 write the masters in place (views of the
flat buffer), then each half parameter takes its update.
"""

import dataclasses

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             GradientTransformation,
                                             apply_plain, copy_into)
from apex_tpu_torch.optimizers._fused import get_meta
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMBState, fused_lamb


@dataclasses.dataclass
class MixedPrecisionLambState:
    master_flat: torch.Tensor  # fp32 flat master parameters
    inner: FusedLAMBState

    @classmethod
    def from_numpy(cls, master_flat, inner, device=None):
        """A state from host arrays: ``master_flat`` the flat fp32 masters
        in the leaf order of ``inner``'s ``m`` (a JAX state's), ``inner``
        a ``(count, m, v)`` triple as :meth:`FusedLAMBState.from_numpy`
        takes it; ``device=None`` means ``cuda``."""
        device = default_device(device)
        flat = torch.from_numpy(np.array(master_flat, dtype=np.float32))
        return cls(flat.to(device), FusedLAMBState.from_numpy(*inner,
                                                              device=device))


def _masters(state):
    """The masters as views of the flat buffer, keyed in the state's order."""
    names = list(state.inner.m)
    meta = get_meta([state.inner.m[n] for n in names])
    return dict(zip(names, meta.unflatten(state.master_flat)))


def fused_mixed_precision_lamb(learning_rate=1e-3, betas=(0.9, 0.999),
                               eps=1e-6, weight_decay=0.01,
                               bias_correction=True, grad_averaging=True,
                               max_grad_norm=1.0, use_nvlamb=False):
    """``(init, update, step)``: half (or any) parameters and gradients,
    fp32 masters; the updates come back in the parameters' dtype."""
    lamb = fused_lamb(learning_rate=learning_rate, betas=betas, eps=eps,
                      weight_decay=weight_decay,
                      bias_correction=bias_correction,
                      grad_averaging=grad_averaging,
                      max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)

    def init(params):
        names = list(params)
        leaves = [params[n] for n in names]
        meta = get_meta(leaves)
        master_flat = meta.flatten(leaves)
        masters = dict(zip(names, meta.unflatten(
            master_flat, [torch.float32] * meta.num_tensors)))
        return MixedPrecisionLambState(master_flat, lamb.init(masters))

    def _half_updates(masters, params):
        return {n: (nm.to(params[n].dtype).float() - params[n].float())
                .to(params[n].dtype) for n, nm in masters.items()}

    def update(grads, state, params):
        masters = _masters(state)
        fp32_grads = {n: grads[n].float() for n in masters}
        upd, inner = lamb.update(fp32_grads, state.inner, masters)
        new_masters = {n: masters[n] + upd[n] for n in masters}
        new_flat = torch.cat([t.reshape(-1) for t in new_masters.values()])
        return (_half_updates(new_masters, params),
                MixedPrecisionLambState(new_flat, inner))

    @torch.no_grad()
    def step(grads, state, params, found_inf=None, model_params=None):
        names = list(grads)
        if not names or not grads[names[0]].is_cuda:
            apply_plain(update, grads, state, params, found_inf)
            copy_into(params, model_params)
            return state
        masters = _masters(state)
        lamb.step({n: grads[n].float() for n in masters}, state.inner,
                  masters, found_inf)
        for n, u in _half_updates(masters, params).items():
            p = params[n]
            new = p + u
            p.copy_(new if found_inf is None
                    else torch.where(found_inf, p, new))
        copy_into(params, model_params)
        return state

    return GradientTransformation(init, update, step)


class FusedMixedPrecisionLamb(FusedOptimizerBase):
    """The class surface (apex's ``FusedMixedPrecisionLamb``)."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, grad_averaging=True, set_grad_none=True,
                 max_grad_norm=1.0, use_nvlamb=False, step=0,
                 reduced_precision_dtype=None):
        if amsgrad:
            raise RuntimeError(
                "FusedMixedPrecisionLamb does not support the AMSGrad variant.")
        super().__init__(params, dict(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            max_grad_norm=max_grad_norm))
        self.use_nvlamb = use_nvlamb

    def _group_tx(self, group):
        return fused_mixed_precision_lamb(
            learning_rate=group["lr"], betas=group["betas"], eps=group["eps"],
            weight_decay=group["weight_decay"],
            bias_correction=group["bias_correction"],
            grad_averaging=group["grad_averaging"],
            max_grad_norm=group["max_grad_norm"], use_nvlamb=self.use_nvlamb)
