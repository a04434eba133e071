"""DistributedFusedAdam: ZeRO-2 sharded Adam (counterpart of
``apex_tpu/contrib/optimizers/distributed_fused_adam.py``).

The parameters are flattened into one padded fp32 buffer; each rank of
the data-parallel group keeps the fp32 master, ``m`` and ``v`` of its
shard only. A step is three collectives around flat math:

    flat grads ──reduce-scatter──► my grad shard        (ZeRO grad sync)
    my (m, v, master) shard ──Adam (K21)──► my update shard
    my update shard ──all-gather──► full flat update   (ZeRO param sync)

The hops go through :mod:`apex_tpu_torch.parallel.collectives`, so the
compression (int8 with error feedback, the residuals carried in the
state) and hierarchical knobs apply. Gradients given to the transform are
each rank's own; the transform reduces them. ``axis_name`` is a process
group (None: the default one) or an ``(inner, outer)`` pair.

Besides JAX's pure ``update``, the transform has the in-place fused form
``step(grads, state, params, found_inf=None, model_params=None)`` that
``train_step.make_one_step`` calls: the reduce-scatter, the division by
``num_shards`` (a 0-d device tensor), the global-norm clip, K21 on the
card (``ops/zero.adam``), the update all-gather, then ``p + u`` in each
parameter's dtype. Every rank runs the collectives on a step whose
found-inf flag is set, but nothing is written then: not ``m``, ``v``,
the master or the count, not the residuals, not the parameters.
"""

import dataclasses

import numpy as np
import torch

from apex_tpu_torch import default_device, device_scalar
from apex_tpu_torch.ops import multi_tensor
from apex_tpu_torch.ops import zero as zero_ops
from apex_tpu_torch.optimizers._base import (GradientTransformation,
                                             copy_into)
from apex_tpu_torch.optimizers._fused import (get_meta, zero_ef_residuals,
                                              zero_gather_updates,
                                              zero_grad_shard,
                                              zero_master_shard)
from apex_tpu_torch.parallel import collectives

__all__ = ["DistAdamState", "DistributedFusedAdam", "distributed_fused_adam"]


def _vec(a, device):
    return None if a is None else torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device)


@dataclasses.dataclass
class DistAdamState:
    count: torch.Tensor   # 0-d int32
    m: torch.Tensor       # [padded_total / num_shards] fp32, this rank's
    v: torch.Tensor
    master: torch.Tensor  # fp32 master of this rank's parameter shard
    # the error-feedback residuals of the quantized hops (None when the
    # codec is off)
    g_residual: torch.Tensor = None   # grad reduce-scatter
    u_residual: torch.Tensor = None   # update all-gather

    @classmethod
    def from_numpy(cls, count, m, v, master, g_residual=None,
                   u_residual=None, device=None):
        """A state from host arrays (e.g. one rank's slice of a JAX
        state); ``device=None`` means ``cuda``."""
        device = default_device(device)
        return cls(torch.tensor(np.int32(count), device=device),
                   _vec(m, device), _vec(v, device), _vec(master, device),
                   _vec(g_residual, device), _vec(u_residual, device))

    def clone(self):
        return dataclasses.replace(self, **{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).clone()
            for f in dataclasses.fields(self)})


def _kept(found_inf, old, new):
    """The new residual, or the old one where ``found_inf`` is set
    (selected into ``new``'s storage)."""
    if found_inf is None or new is None:
        return new
    return torch.where(found_inf, old, new, out=new)


def global_sq(g_shard, axis_name):
    """The gradients' sum of squares over the group: this shard's (K13 on
    the card) all-reduced."""
    local = multi_tensor.l2norm([g_shard]).total_sq.reshape(1)
    group = collectives._flat_group(collectives.axes_tuple(axis_name))
    return collectives._psum(local, group)[0]


class ZeroTransform:
    """What the two ZeRO transforms share: the knobs resolved once, the
    state's shard and residuals made by :meth:`init`, the gradient and
    update hops, and the parameters written from the gathered update.
    A subclass gives :meth:`shard_update` (in place on the state;
    returns the update shard)."""

    state_class = None

    def __init__(self, num_shards, axis_name, grad_compress,
                 hier_allreduce, gather_dtype=torch.float32):
        self.num_shards = num_shards
        self.axis_name = axis_name
        self.scheme = collectives.resolve_compress(grad_compress)
        self.hier = collectives.resolve_hier(
            hier_allreduce, collectives.axes_tuple(axis_name))
        self.compress = self.scheme if self.scheme is not None else False
        self.gather_dtype = gather_dtype

    def init(self, params):
        leaves = list(params.values())
        meta = get_meta(leaves)
        master = zero_master_shard(meta, leaves, self.num_shards,
                                   self.axis_name)
        g_res = u_res = None
        if self.scheme is not None:
            g_res, u_res = zero_ef_residuals(meta.total, self.num_shards,
                                             self.axis_name, self.hier,
                                             master.device)
        return self.state_class(
            count=torch.zeros((), dtype=torch.int32, device=master.device),
            m=torch.zeros_like(master), v=torch.zeros_like(master),
            master=master, g_residual=g_res, u_residual=u_res)

    def _hops(self, grads, state, params, found_inf):
        """The reduce-scatter, the shard update, the all-gather: returns
        the names and the per-tensor updates in the parameters' dtypes."""
        names = list(params)
        leaves_p = [params[n] for n in names]
        meta = get_meta(leaves_p)
        g_shard, g_res = zero_grad_shard(
            meta, [grads[n] for n in names], self.num_shards, self.axis_name,
            compress=self.compress, hierarchical=self.hier,
            residual=state.g_residual)
        u = self.shard_update(meta, g_shard, state, found_inf)
        ups, u_res = zero_gather_updates(
            meta, u, self.axis_name, [p.dtype for p in leaves_p],
            self.gather_dtype, compress=self.compress,
            hierarchical=self.hier, residual=state.u_residual)
        state.g_residual = _kept(found_inf, state.g_residual, g_res)
        state.u_residual = _kept(found_inf, state.u_residual, u_res)
        return names, ups

    def shard_update(self, meta, g_shard, state, found_inf):
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads, state, params):
        """JAX's pure update: ``(updates, new_state)``, ``updates`` keyed
        like ``params`` in their dtypes; ``state`` is left as it was."""
        new_state = state.clone()
        names, ups = self._hops(grads, new_state, params, None)
        return dict(zip(names, ups)), new_state

    @torch.no_grad()
    def step(self, grads, state, params, found_inf=None, model_params=None):
        """The in-place fused step: the state and each ``p + u`` (in p's
        dtype) written, nothing where ``found_inf`` is set."""
        names, ups = self._hops(grads, state, params, found_inf)
        ps = [params[n] for n in names]
        new = torch._foreach_add(ps, ups)
        for p, n in zip(ps, new):
            p.copy_(n if found_inf is None else torch.where(found_inf, p, n))
        copy_into(params, model_params)
        return state

    def transform(self):
        return GradientTransformation(self.init, self.update, self.step)


class _DistAdam(ZeroTransform):
    state_class = DistAdamState

    def __init__(self, learning_rate, betas, eps, weight_decay, adam_w_mode,
                 bias_correction, max_grad_norm, grad_average, **kw):
        super().__init__(**kw)
        self.lr = learning_rate
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.max_grad_norm = max_grad_norm
        self.grad_average = grad_average

    def shard_update(self, meta, g_shard, state, found_inf):
        if self.grad_average:
            g_shard = g_shard / device_scalar(self.num_shards, g_shard)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            gnorm = torch.sqrt(global_sq(g_shard, self.axis_name))
            g_shard = g_shard / torch.clamp(
                gnorm / device_scalar(self.max_grad_norm, g_shard), min=1.0)
        count = state.count + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        bc1 = bc2 = None
        if self.bias_correction:
            t = count.float()
            bc1 = 1.0 - torch.pow(self.beta1, t)
            bc2 = 1.0 - torch.pow(self.beta2, t)
        return zero_ops.adam(
            g_shard, state.master, state.m, state.v, state.count, count, bc1,
            bc2, lr, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
            weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction, skip=found_inf)


def distributed_fused_adam(learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, adam_w_mode=True,
                           bias_correction=True, max_grad_norm=0.0, *,
                           num_shards, axis_name=None, grad_average=True,
                           grad_compress=None, hier_allreduce=None):
    """ZeRO-2 Adam as ``(init, update, step)`` over dicts of tensors keyed
    by name, for one rank of the group ``axis_name``. ``num_shards`` must
    be the group's size. The gradients are each rank's own; the
    transform reduce-scatters them (do not average them first).
    ``grad_compress`` / ``hier_allreduce`` are the per-call knobs (raise
    on a request that cannot be honoured; None consults the preferences),
    resolved once here, since the state's residual slots must agree
    between ``init`` and every step."""
    return _DistAdam(learning_rate, betas, eps, weight_decay, adam_w_mode,
                     bias_correction, max_grad_norm, grad_average,
                     num_shards=num_shards, axis_name=axis_name,
                     grad_compress=grad_compress,
                     hier_allreduce=hier_allreduce).transform()


def _named(params):
    if isinstance(params, dict):
        return dict(params)
    return {str(i): p for i, p in enumerate(params)}


class ZeroOptimizer:
    """The class surface the two ZeRO optimizers share: ``params`` a dict
    of tensors or an iterable of them; :meth:`step` takes a dict of
    gradients keyed like them (or reads each ``p.grad``) and updates the
    parameters in place."""

    def __init__(self, params, tx):
        self.params = _named(params)
        self.tx = tx
        self.state = None

    def init(self):
        self.state = self.tx.init(self.params)
        return self.state

    def step(self, grads=None, found_inf=None):
        if grads is None:
            grads = {n: p.grad for n, p in self.params.items()}
        elif not isinstance(grads, dict):
            grads = dict(zip(self.params, grads))
        if self.state is None:
            self.init()
        self.tx.step(grads, self.state, self.params, found_inf)
        return self.params

    def zero_grad(self, set_to_none=True):
        for p in self.params.values():
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()


class DistributedFusedAdam(ZeroOptimizer):
    """apex's class surface: the CUDA overlap and tuning arguments are
    accepted and change nothing; ``adam_w_mode`` is False (L2 decay into
    the gradient), as the reference's; ``amsgrad`` is refused."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, amsgrad=False,
                 flat_mt=False, overlap_reductions=True,
                 compute_L2_grad_norm=False, distributed_weight_update=0,
                 dwu_group_size=0, dwu_num_blocks=4, dwu_num_rs_pg=1,
                 dwu_num_ar_pg=4, dwu_num_ag_pg=0, dwu_num_chunks=4,
                 revert_method=1, full_pipeline=True, e5m2_allgather=False,
                 *, num_shards, axis_name=None, grad_compress=None,
                 hier_allreduce=None):
        assert not amsgrad, "amsgrad is not supported (as in the reference)"
        super().__init__(params, distributed_fused_adam(
            learning_rate=lr, betas=betas, eps=eps,
            weight_decay=weight_decay, bias_correction=bias_correction,
            adam_w_mode=False, max_grad_norm=max_grad_norm,
            num_shards=num_shards, axis_name=axis_name,
            grad_compress=grad_compress, hier_allreduce=hier_allreduce))

    def init_params(self, params=None):
        """The reference's pre-registration hook: nothing to register (the
        state covers the constructor's parameters and is made by the first
        step); returns the current state."""
        del params
        return self.state
