"""FP16_Optimizer: manual master-weight mixed precision (counterpart of
``apex_tpu/fp16_utils/fp16_optimizer.py``; deprecated in apex in favour
of amp O2).

It wraps a transform of :mod:`apex_tpu_torch.optimizers` (e.g.
``fused_adam(lr)``) with fp32 master copies of the (half) model
parameters, static or dynamic loss scaling (the device state machine of
:class:`apex_tpu_torch.amp.LossScaler`), and the reference's imperative
surface: ``backward`` stashes the scaled gradients, ``step`` unscales
them, skips the step on an overflow (printing it, as the reference
does), updates the masters and copies them into the model's dtypes.
"""

import warnings

import torch

from apex_tpu_torch.amp.scaler import LossScaler as _PureScaler
from apex_tpu_torch.fp16_utils.fp16util import (
    clip_grad_norm, master_params_to_model_params,
    model_grads_to_master_grads, prep_param_lists)
from apex_tpu_torch.optimizers._base import apply_plain


class FP16_Optimizer:
    """``tx`` is a transform; ``params`` the model's (half) parameters, a
    dict of tensors keyed by name."""

    def __init__(self, tx, params, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=True):
        if verbose:
            warnings.warn(
                "FP16_Optimizer is deprecated and will be removed; use amp "
                "O2 (apex_tpu_torch.amp.initialize) instead.", FutureWarning)
        self.tx = tx
        self.model_params = dict(params)
        _, self.master_params = prep_param_lists(self.model_params)
        self.opt_state = tx.init(self.master_params)
        kwargs = dict(dynamic_loss_args or {})
        if dynamic_loss_scale:
            self.scaler = _PureScaler(loss_scale="dynamic", **kwargs)
        else:
            self.scaler = _PureScaler(loss_scale=float(static_loss_scale))
        device = next(iter(self.master_params.values())).device
        self.scaler_state = self.scaler.init(device)
        self.overflow = False
        self._grads = None
        self._clip = None

    @property
    def loss_scale(self):
        return float(self.scaler_state.loss_scale)

    def scale_loss(self, loss):
        return self.scaler.scale(loss, self.scaler_state)

    def backward(self, loss_or_fn, *args, **kwargs):
        """Stashes the gradients of the scaled loss for :meth:`step` and
        returns the unscaled loss. ``loss_or_fn`` is a loss tensor (its
        scaled value is back-propagated into the model parameters'
        ``grad``) or a function ``(*args) -> (loss, grads)`` built on the
        scaled loss (``scale_loss`` inside it), as JAX's takes."""
        if callable(loss_or_fn):
            loss, grads = loss_or_fn(*args, **kwargs)
        else:
            loss = loss_or_fn
            self.scale_loss(loss).backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in self.model_params.items()}
            loss = self.scale_loss(loss.detach())
        self._grads = grads
        return loss / self.scaler_state.loss_scale

    def clip_master_grads(self, max_norm, norm_type=2):
        """The unscaled gradients' norm before clipping; arms the clip for
        the next :meth:`step` only."""
        assert self._grads is not None, \
            "call backward() before clip_master_grads()"
        master_grads = model_grads_to_master_grads(self._grads)
        inv = self.scaler_state.loss_scale
        _, total_norm = clip_grad_norm(
            {n: g / inv for n, g in master_grads.items()}, max_norm,
            norm_type)
        self._clip = (max_norm, norm_type)
        return total_norm

    @torch.no_grad()
    def step(self):
        """Unscale, check for overflow, update the masters, copy them into
        the model's dtypes; an overflow skips the step and backs the scale
        off."""
        assert self._grads is not None, "call backward() before step()"
        master_grads = model_grads_to_master_grads(self._grads)
        master_grads, found_inf = self.scaler.unscale(master_grads,
                                                      self.scaler_state)
        self.scaler_state = self.scaler.update(self.scaler_state, found_inf)
        self.overflow = bool(found_inf)
        self._grads = None
        if self.overflow:
            print(f"OVERFLOW! Skipping step. Reducing loss scale to "
                  f"{self.loss_scale}")
            self._clip = None
            return
        if self._clip:
            master_grads, _ = clip_grad_norm(master_grads, *self._clip)
            self._clip = None
        apply_plain(self.tx.update, master_grads, self.opt_state,
                    self.master_params)
        new = master_params_to_model_params(self.model_params,
                                            self.master_params)
        for n, p in self.model_params.items():
            p.copy_(new[n])

    def zero_grad(self, set_grads_to_None=True):
        self._grads = None
        for p in self.model_params.values():
            if set_grads_to_None:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_dict(self):
        return {"opt_state": self.opt_state,
                "master_params": self.master_params,
                "scaler_state": _PureScaler.state_dict(self.scaler_state),
                "overflow": self.overflow}

    def load_state_dict(self, d):
        self.opt_state = d["opt_state"]
        self.master_params = d["master_params"]
        self.scaler_state = _PureScaler.load_state_dict(self.scaler_state,
                                                        d["scaler_state"])
        self.overflow = d["overflow"]
        new = master_params_to_model_params(self.model_params,
                                            self.master_params)
        with torch.no_grad():
            for n, p in self.model_params.items():
                p.copy_(new[n])
