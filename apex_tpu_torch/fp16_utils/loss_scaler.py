"""The legacy loss scalers (counterpart of
``apex_tpu/fp16_utils/loss_scaler.py``): the pre-amp :class:`LossScaler`
(static) and :class:`DynamicLossScaler`, mutable objects stepped on the
host, with the reference's quirks (no upper clamp, a floor of 1). A
training step that must not wait on the host uses
:class:`apex_tpu_torch.amp.LossScaler` instead."""

import torch


class LossScaler:
    """Static loss scaling."""

    def __init__(self, scale=1):
        self.cur_scale = scale

    def has_overflow(self, params):
        return False

    @staticmethod
    def _has_inf_or_nan(x):
        return not bool(torch.isfinite(torch.as_tensor(x)).all())

    def update_scale(self, overflow):
        pass

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, grads):
        return {n: g * self.loss_scale for n, g in grads.items()}

    def backward(self, loss_and_grad_fn, *args):
        """``(loss, gradients of the scaled loss)`` from
        ``loss_and_grad_fn(*args) -> (loss, grads)``: the apex contract
        where the caller divides by ``loss_scale`` before the update."""
        loss, grads = loss_and_grad_fn(*args)
        return loss, self.scale_gradient(grads)


class DynamicLossScaler(LossScaler):
    """Dynamic scaling: / ``scale_factor`` on overflow (at least 1), x
    ``scale_factor`` after ``scale_window`` clean steps."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0,
                 scale_window=1000):
        self.cur_scale = init_scale
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def has_overflow(self, params):
        """Whether any tensor of ``params`` (a dict or a list) holds an inf
        or a NaN (a host check)."""
        leaves = params.values() if isinstance(params, dict) else params
        return any(self._has_inf_or_nan(p) for p in leaves)

    def update_scale(self, overflow):
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) \
                % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1

    @property
    def loss_scale(self):
        return self.cur_scale
