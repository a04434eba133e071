"""Dynamic loss scaling on device tensors (counterpart of
``apex_tpu/amp/scaler.py``).

:class:`LossScaler` holds the static configuration and the pure
transitions; :class:`LossScalerState` holds the state as 0-d device
tensors (``loss_scale`` fp32, ``unskipped`` int32, ``overflow`` bool).
Init 2**16, x2 every ``scale_window`` unskipped steps (clamped to
``max_loss_scale``), x``backoff`` on overflow (clamped to
``min_loss_scale``). The overflow flag is a device bool from an
``isfinite`` reduction over the gradients, and every transition is a
``torch.where`` select, so a training step never waits on the host to
decide whether to skip: nothing here calls ``.item()``. On CUDA
:meth:`LossScaler.unscale` is one K12 launch a group of gradients
(``ops/multi_tensor_cuda.scale``), which writes the fp32 unscaled
gradients and the flag in one pass.
"""

import dataclasses

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.ops import multi_tensor


@dataclasses.dataclass
class LossScalerState:
    """The mutable part of a LossScaler: 0-d tensors on one device."""

    loss_scale: torch.Tensor   # fp32
    unskipped: torch.Tensor    # int32: steps since the last overflow
    overflow: torch.Tensor     # bool: the last step's overflow flag

    @classmethod
    def from_numpy(cls, loss_scale, unskipped, overflow=False, device=None):
        """A state from host numbers (e.g. a JAX state's leaves after
        ``np.asarray``) on ``device`` (None means ``cuda``)."""
        device = default_device(device)
        return cls(
            loss_scale=torch.tensor(np.float32(loss_scale), device=device),
            unskipped=torch.tensor(np.int32(unskipped), device=device),
            overflow=torch.tensor(bool(overflow), device=device))


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static config + transitions. ``loss_scale`` is a number (static)
    or "dynamic"."""

    loss_scale: object = "dynamic"
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_loss_scale: float = None
    max_loss_scale: float = 2.0 ** 24
    backoff_factor: float = None  # None → 1/scale_factor

    @property
    def dynamic(self):
        return self.loss_scale == "dynamic"

    def init(self, device=None):
        scale = self.init_scale if self.dynamic else float(self.loss_scale)
        return LossScalerState.from_numpy(scale, 0, False, device)

    def scale(self, loss, state):
        return loss.float() * state.loss_scale

    def unscale(self, grads, state):
        """``(unscaled, found_inf)``: the gradients (a dict of tensors)
        times ``1 / loss_scale`` in fp32, and one device bool that is
        True when any gradient holds an inf or a NaN (K12 on CUDA)."""
        names = list(grads)
        inv = 1.0 / state.loss_scale
        unscaled, found_inf = multi_tensor.scale(
            [grads[n] for n in names], [torch.float32] * len(names), inv,
            check_input=True, flag_dtype=torch.bool)
        return dict(zip(names, unscaled)), found_inf

    def update(self, state, found_inf):
        """The scale-update state machine: on overflow scale =
        max(scale * backoff, min_loss_scale) and unskipped = 0; else
        unskipped += 1, and at ``scale_window`` scale = min(scale *
        factor, max_loss_scale) and unskipped = 0. Static scaling only
        records the overflow."""
        if not self.dynamic:
            return LossScalerState(state.loss_scale, state.unskipped,
                                   found_inf)
        min_scale = (self.min_loss_scale if self.min_loss_scale is not None
                     else 0.0)
        backoff = (self.backoff_factor if self.backoff_factor is not None
                   else 1.0 / self.scale_factor)
        shrunk = torch.clamp(state.loss_scale * backoff, min=min_scale)
        unskipped = torch.where(found_inf, 0, state.unskipped + 1)
        grow = unskipped == self.scale_window
        grown = torch.clamp(state.loss_scale * self.scale_factor,
                            max=self.max_loss_scale)
        new_scale = torch.where(found_inf, shrunk,
                                torch.where(grow, grown, state.loss_scale))
        new_unskipped = torch.where(grow, 0, unskipped)
        return LossScalerState(new_scale.float(),
                               new_unskipped.to(torch.int32), found_inf)

    @staticmethod
    def state_dict(state):
        return {"loss_scale": state.loss_scale,
                "unskipped": state.unskipped}

    @staticmethod
    def load_state_dict(state, d):
        dev = state.loss_scale.device
        return LossScalerState(
            loss_scale=torch.as_tensor(d["loss_scale"], dtype=torch.float32,
                                       device=dev),
            unskipped=torch.as_tensor(d["unskipped"], dtype=torch.int32,
                                      device=dev),
            overflow=state.overflow)
