"""Fused SGD with momentum (counterpart of
``apex_tpu/optimizers/fused_sgd.py``).

JAX's update: weight decay folded into the gradient, the momentum buffer
set to the gradient on the first step (``buf = g``, PyTorch's rule) and
``mu buf + (1 - dampening) g`` after, Nesterov's ``g + mu buf``, and ``-lr
d`` cast to the gradient's dtype; the learning rate is a number or a
schedule of the new step count, a 0-d int32 device tensor, so that it is
computed on the device. The state, :class:`FusedSGDState`, is the count
and an fp32 buffer per parameter.

``update`` is that function in plain PyTorch (JAX computes it in jnp
with no Pallas kernel). ``step(grads, state, params, found_inf=None,
model_params=None)`` is the in-place fused form: on CUDA tensors one K16
launch a group of leaves (``csrc/multi_tensor.cu``,
``ops/multi_tensor_cuda.sgd``) writes p, the buffer and the count in the
same fp32 order, so it equals ``apply_plain`` over ``update`` bit for
bit, and with ``model_params`` it also writes each new parameter into
its model copy in the copy's dtype (amp O2's master-to-model copy in the
same pass); where ``found_inf`` is set it writes nothing. On the CPU it
is the plain form, then the copy.
"""

import dataclasses

import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             GradientTransformation,
                                             apply_plain, copy_into,
                                             count_from_numpy,
                                             tensors_from_numpy)


@dataclasses.dataclass
class FusedSGDState:
    count: torch.Tensor   # 0-d int32 step count
    momentum_buf: dict    # name -> fp32 momentum buffer

    @classmethod
    def from_numpy(cls, count, momentum_buf, device=None):
        """A state from host arrays (``momentum_buf`` a nested dict keyed
        like the JAX parameter tree); ``device=None`` means ``cuda``."""
        device = default_device(device)
        return cls(count_from_numpy(count, device),
                   tensors_from_numpy(momentum_buf, device))


def fused_sgd(learning_rate=1e-3, momentum=0.0, dampening=0.0,
              weight_decay=0.0, nesterov=False):
    """Fused SGD as ``(init, update, step)`` over dicts of tensors
    keyed by name; ``learning_rate`` a float or a schedule of the new step
    count."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("Nesterov momentum requires a momentum and zero dampening")

    def init(params):
        device = next(iter(params.values())).device
        return FusedSGDState(
            torch.zeros((), dtype=torch.int32, device=device),
            {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()})

    def update(grads, state, params):
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) \
            else learning_rate
        neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
        updates, bufs = {}, {}
        for n, gl in grads.items():
            g = gl.float()
            if weight_decay != 0:
                g = g + weight_decay * params[n].float()
            buf = state.momentum_buf[n]
            if momentum != 0:
                buf = torch.where(count == 1, g,
                                  momentum * buf + (1.0 - dampening) * g)
                d = g + momentum * buf if nesterov else buf
            else:
                d = g
            updates[n] = (neg_lr * d).to(gl.dtype)
            bufs[n] = buf
        return updates, FusedSGDState(count, bufs)

    def step(grads, state, params, found_inf=None, model_params=None):
        names = list(grads)
        if not names or not grads[names[0]].is_cuda:
            apply_plain(update, grads, state, params, found_inf)
            copy_into(params, model_params)
            return state
        from apex_tpu_torch.ops import multi_tensor_cuda

        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) \
            else learning_rate
        multi_tensor_cuda.sgd(
            [grads[n] for n in names], [params[n] for n in names],
            [state.momentum_buf[n] for n in names],
            None if model_params is None
            else [model_params[n] for n in names],
            state.count, count, lr, weight_decay=weight_decay,
            momentum=momentum, dampening=dampening, nesterov=nesterov,
            skip=found_inf)
        return state

    return GradientTransformation(init, update, step)


class FusedSGD(FusedOptimizerBase):
    """The class surface (apex's ``FusedSGD``). ``wd_after_momentum`` and
    ``materialize_master_grads`` are amp's eager-mode knobs, accepted and
    unused, as in the JAX package."""

    def __init__(self, params, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      dampening=dampening,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))

    def _group_tx(self, group):
        return fused_sgd(learning_rate=group["lr"], momentum=group["momentum"],
                         dampening=group["dampening"],
                         weight_decay=group["weight_decay"],
                         nesterov=group["nesterov"])

    def get_momentums(self, params=None):
        """``(momentums, first_run)`` as apex's: every group's momentum
        buffers, zero and kept from the first call for a group not yet
        stepped (``first_run`` True then). ``params`` is accepted for
        signature parity."""
        del params
        grow = len(self.param_groups) - len(self.group_states)
        self.group_states += [None] * grow
        self._txs += [None] * grow
        bufs, first_run = [], False
        for i, group in enumerate(self.param_groups):
            if self.group_states[i] is None:
                self.group_states[i] = self._transform(i, group).init(
                    {str(j): p for j, p in enumerate(group["params"])})
                first_run = True
            bufs.extend(self.group_states[i].momentum_buf.values())
        return bufs, first_run


def get_momentums(state):
    """The momentum buffers of a ``fused_sgd`` state, in its order."""
    return list(state.momentum_buf.values())
