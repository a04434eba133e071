"""Master weights, loss scaling and the skip step around an optimizer
(counterpart of ``apex_tpu/amp/amp_optimizer.py``).

:class:`AmpOptimizer` wraps a transform of
:mod:`apex_tpu_torch.optimizers`. With ``master_weights`` its state keeps
fp32 masters, made at :meth:`~AmpOptimizer.init` from the parameters as
they are then (already cast by ``amp.initialize``, so the masters start
half-rounded, as the JAX example's ``opt.init(params)`` makes them), and
one scaler state per loss. :meth:`~AmpOptimizer.apply_gradients` unscales
(K12 on the card) unless told the gradients are unscaled, advances one
loss's scaler, steps the optimizer on the masters (or, without masters,
on the parameters), keeps everything where the found-inf flag is set, and
copies the masters into the model's parameters in their dtypes.

The JAX optimizer is pure; this one updates in place to save memory: the
parameters, the masters and the inner state are overwritten (left as they
were on overflow), and the returned state shares them. Where the
transform has an in-place fused ``step``, that is what runs, and it
writes the model copy too (``fused_sgd``'s K16 in the same pass); else
the copy is K12 (``ops/multi_tensor.scale`` to the model's dtypes), as
apex's ``_process_optimizer`` copies with ``multi_tensor_scale``. Nothing here reads a device value on the
host.
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.optimizers._base import apply_plain, copy_into


@dataclasses.dataclass
class AmpOptState:
    inner: Any                      # the wrapped transform's state
    master_params: Optional[dict]   # fp32 masters (None without them)
    scalers: Tuple[Any, ...]        # one LossScalerState per loss

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class AmpOptimizer:
    """A transform with amp semantics; built directly or by
    ``amp.initialize``. ``param_dtype`` is the policy's (recorded, as in
    JAX)."""

    tx: Any
    scaler: LossScaler = LossScaler(loss_scale="dynamic")
    num_losses: int = 1
    master_weights: bool = False
    param_dtype: Any = torch.float32

    def init(self, params):
        """The state for ``params`` (a dict of the model's parameters):
        fp32 master copies with ``master_weights``, the transform's state
        over what it steps, a scaler state a loss on their device."""
        device = next(iter(params.values())).device
        master = None
        if self.master_weights:
            master = {n: (p.detach().float().clone() if p.is_floating_point()
                          else p.detach().clone())
                      for n, p in params.items()}
        inner = self.tx.init(master if master is not None else params)
        scalers = tuple(self.scaler.init(device)
                        for _ in range(self.num_losses))
        return AmpOptState(inner=inner, master_params=master, scalers=scalers)

    def scale_loss(self, loss, state, loss_id=0):
        return self.scaler.scale(loss, state.scalers[loss_id])

    def unscale(self, grads, state, loss_id=0):
        """``(fp32 unscaled gradients, found_inf)`` (K12 on the card)."""
        return self.scaler.unscale(grads, state.scalers[loss_id])

    def update_scaler(self, state, found_inf, loss_id=0):
        """A state with one loss's scaler advanced and nothing stepped
        (for losses that share an ``apply_gradients`` of another)."""
        new = self.scaler.update(state.scalers[loss_id], found_inf)
        return state.replace(scalers=tuple(
            new if i == loss_id else s for i, s in enumerate(state.scalers)))

    def apply_gradients(self, grads, state, params, loss_id=0,
                        grads_already_unscaled=False, found_inf=None,
                        scaler_found_inf=None):
        """One step with amp semantics. ``grads``: a dict keyed like
        ``params``, of the scaled loss unless ``grads_already_unscaled``
        (then ``found_inf`` is required); ``found_inf`` is the skip
        predicate and ``scaler_found_inf`` (default ``found_inf``) the
        flag that advances ``loss_id``'s scale. Returns ``(params,
        new_state, {"overflow", "loss_scale"})`` with ``params`` and the
        state's tensors updated in place."""
        sstate = state.scalers[loss_id]
        if grads_already_unscaled:
            if found_inf is None:
                raise ValueError("apply_gradients: unscaled gradients need "
                                 "their found_inf flag")
            fp32 = {n: g.float() for n, g in grads.items()}
        else:
            fp32, found_inf = self.scaler.unscale(grads, sstate)
        new_sstate = self.scaler.update(
            sstate, found_inf if scaler_found_inf is None
            else scaler_found_inf)
        with torch.no_grad():
            if self.master_weights:
                self._step(fp32, state.inner, state.master_params, found_inf,
                           model_params=params)
            else:
                self._step(fp32, state.inner, params, found_inf)
        scalers = tuple(new_sstate if i == loss_id else s
                        for i, s in enumerate(state.scalers))
        info = {"overflow": found_inf, "loss_scale": new_sstate.loss_scale}
        return params, state.replace(scalers=scalers), info

    def _step(self, grads, inner, opt_params, found_inf, model_params=None):
        step = getattr(self.tx, "step", None)
        if step is not None:
            step(grads, inner, opt_params, found_inf,
                 model_params=model_params)
        else:
            apply_plain(self.tx.update, grads, inner, opt_params, found_inf)
            copy_into(opt_params, model_params)
