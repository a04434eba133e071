"""What the fused optimizers share (counterpart of
``apex_tpu/optimizers/_base.py``).

Each optimizer is a :class:`GradientTransformation` over dicts of tensors
keyed by parameter name: ``init(params)``, ``update(grads, state, params)
-> (updates, new_state)`` (the JAX transform's function, pure) and, for
the optimizers that have kernels (Adam, LAMB, SGD), ``step(grads,
state, params, found_inf=None, model_params=None)``, the in-place fused
form that writes the parameters and the state, or leaves them bitwise
unchanged where the 0-d bool ``found_inf`` is set, and then writes the
parameters into ``model_params`` (half model copies of fp32 masters) in
their dtypes: SGD's K16 in the same pass, the others by
:func:`copy_into`. Its plain version is :func:`apply_plain`: the
update, then ``bench.py:240-245``'s skip selects written in place.
:class:`FusedOptimizerBase` is the class surface in PyTorch's idiom.
"""

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch._tree import flatten_tree
from apex_tpu_torch.ops import multi_tensor


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable
    step: Callable = None


def tensors_from_numpy(tree, device):
    """A nested dict of host arrays as a flat dict of fp32 tensors keyed by
    dotted names (the port's parameter names)."""
    return {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for n, a in flatten_tree(tree).items()}


def count_from_numpy(count, device):
    return torch.tensor(np.int32(count), device=default_device(device))


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def grad_norm_stats(grads, device=None):
    """``{"grad_norm", "grad_max"}`` over the gradients (a dict or a list
    of tensors), fp32 0-d tensors that stay on the device: the global L2
    norm of the per-tensor sums and the largest magnitude; K13 on CUDA
    (its L2 and its max mode). An empty list gives zeros on ``device``."""
    leaves = _leaves(grads)
    if not leaves:
        zero = torch.zeros((), dtype=torch.float32,
                           device=default_device(device))
        return {"grad_norm": zero, "grad_max": zero.clone()}
    return {"grad_norm": multi_tensor.l2norm(leaves).total,
            "grad_max": multi_tensor.l2norm(leaves, max_mode=True).total}


def select_into(old, new, found_inf=None):
    """Write ``new`` into ``old`` in place, tensor by tensor through dicts
    and dataclasses, keeping ``old`` where ``found_inf`` is set."""
    if torch.is_tensor(old):
        old.copy_(new if found_inf is None
                  else torch.where(found_inf, old, new))
    elif isinstance(old, dict):
        for k, t in old.items():
            select_into(t, new[k], found_inf)
    elif dataclasses.is_dataclass(old):
        for f in dataclasses.fields(old):
            select_into(getattr(old, f.name), getattr(new, f.name),
                        found_inf)
    else:
        raise TypeError(f"select_into: a {type(old).__name__} in the state")


@torch.no_grad()
def apply_plain(update, grads, state, params, found_inf=None):
    """The plain in-place step: ``update``, then ``p + u`` written into
    each parameter and the new state into ``state``, each kept where
    ``found_inf`` is set. Returns ``state``."""
    updates, new_state = update(grads, state, params)
    for n, u in updates.items():
        p = params[n]
        new = p + u.to(p.dtype)
        p.copy_(new if found_inf is None else torch.where(found_inf, p, new))
    select_into(state, new_state, found_inf)
    return state


@torch.no_grad()
def copy_into(params, model_params):
    """Each of ``params`` (e.g. fp32 masters) written into its entry of
    ``model_params`` (None: nothing to write) in that entry's dtype: K12
    (``multi_tensor.scale`` by 1) on the card, a group of tensors a
    launch, as apex copies masters with ``multi_tensor_scale``."""
    if model_params is None:
        return
    names = [n for n in params if params[n].numel()]
    if not names:
        return
    outs, _ = multi_tensor.scale([params[n] for n in names],
                                 [model_params[n].dtype for n in names], 1.0)
    for n, o in zip(names, outs):
        model_params[n].copy_(o)


class FusedOptimizerBase(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` over a fused transform, one per param
    group: ``step()`` reads each parameter's ``grad`` and updates the
    parameters in place (the transform's fused form where it has one),
    the transform rebuilt when a group's hyperparameters change (as an lr
    schedule does between steps), its state kept. The per-group states
    are ``group_states`` (``state`` stays PyTorch's). A group steps when
    every parameter in it has a gradient, and is skipped when none has."""

    def __init__(self, params, defaults):
        super().__init__(params, dict(defaults))
        self.group_states = []
        self._txs = []

    def _group_tx(self, group):
        raise NotImplementedError

    def _transform(self, i, group):
        key = tuple(sorted((k, repr(v)) for k, v in group.items()
                           if k != "params"))
        if self._txs[i] is None or self._txs[i][0] != key:
            self._txs[i] = (key, self._group_tx(group))
        return self._txs[i][1]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grow = len(self.param_groups) - len(self.group_states)
        self.group_states += [None] * grow
        self._txs += [None] * grow
        for i, group in enumerate(self.param_groups):
            params = {str(j): p for j, p in enumerate(group["params"])}
            grads = {n: p.grad for n, p in params.items()
                     if p.grad is not None}
            if not grads:
                continue
            if len(grads) != len(params):
                raise ValueError(f"param group {i}: {len(grads)} of "
                                 f"{len(params)} parameters have a gradient")
            tx = self._transform(i, group)
            if self.group_states[i] is None:
                self.group_states[i] = tx.init(params)
            if tx.step is not None:
                tx.step(grads, self.group_states[i], params)
            else:
                apply_plain(tx.update, grads, self.group_states[i], params)
        return loss
