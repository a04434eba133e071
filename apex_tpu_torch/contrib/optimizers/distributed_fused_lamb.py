"""DistributedFusedLAMB: ZeRO-sharded LAMB, the optimizer of apex's
BERT-large pretraining recipe (counterpart of
``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``).

The layout and the hops are DistributedFusedAdam's
(:mod:`.distributed_fused_adam`); LAMB adds two reductions over the
group: the global gradient norm (this shard's sum of squares by K13, then
an all-reduce) for the clip, and the per-tensor sums of ``p * p`` and
``u * u`` for the trust ratios, made on each rank's shard per segment (a
tensor's part of the shard; the padding is segment N) and all-reduced as
one ``[2, N + 1]`` buffer, so a tensor that straddles shards gets its
exact norm. On the card K22 (``ops/zero.lamb_stage1`` / ``lamb_stage2``)
computes the moments, the direction and the per-segment sums in a fixed
order, and then the ratio and the update. The update is all-gathered in
fp32, or in bf16 with ``allgather_in_fp32=False`` (the class's
``e5m2_allgather``).
"""

import dataclasses

import torch

from apex_tpu_torch import device_scalar
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistAdamState, ZeroOptimizer, ZeroTransform, global_sq)
from apex_tpu_torch.ops import zero as zero_ops
from apex_tpu_torch.optimizers._fused import shard_layout
from apex_tpu_torch.parallel import collectives

__all__ = ["DistLambState", "DistributedFusedLAMB", "distributed_fused_lamb"]


@dataclasses.dataclass
class DistLambState(DistAdamState):
    """The layout of :class:`DistAdamState`: count, and this rank's fp32
    ``m``, ``v`` and master shards, with the residual slots None when
    the codec is off."""


class _DistLamb(ZeroTransform):
    state_class = DistLambState

    def __init__(self, learning_rate, betas, eps, weight_decay,
                 bias_correction, adam_w_mode, grad_averaging,
                 max_grad_norm, use_nvlamb, **kw):
        super().__init__(**kw)
        self.lr = learning_rate
        self.beta1, self.beta2 = betas
        self.beta3 = 1.0 - self.beta1 if grad_averaging else 1.0
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.trust = weight_decay != 0.0 or use_nvlamb

    def shard_update(self, meta, g_shard, state, found_inf):
        # the average over the ranks is unconditional (grad_averaging
        # selects LAMB's beta3 only, as in the reference)
        g_shard = g_shard / device_scalar(self.num_shards, g_shard)
        clipping = self.max_grad_norm is not None and self.max_grad_norm > 0
        gsq = global_sq(g_shard, self.axis_name) if clipping else None
        count = state.count + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        bc1 = bc2 = None
        if self.bias_correction:
            t = count.float()
            bc1 = 1.0 - torch.pow(self.beta1, t)
            bc2 = 1.0 - torch.pow(self.beta2, t)
        layout = shard_layout(meta, self.num_shards,
                              collectives.axes_index(self.axis_name))
        u, sums = zero_ops.lamb_stage1(
            g_shard, state.master, state.m, state.v, layout, state.count,
            count, bc1, bc2, beta1=self.beta1, beta2=self.beta2,
            beta3=self.beta3, eps=self.eps, weight_decay=self.weight_decay,
            adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction,
            max_grad_norm=self.max_grad_norm, global_sq=gsq,
            skip=found_inf)
        group = collectives._flat_group(collectives.axes_tuple(
            self.axis_name))
        sums = collectives._psum(sums, group)
        return zero_ops.lamb_stage2(u, state.master, sums, layout, lr,
                                    trust=self.trust, skip=found_inf)


def distributed_fused_lamb(learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-6,
                           weight_decay=0.01, bias_correction=True,
                           adam_w_mode=True, grad_averaging=True,
                           max_grad_norm=1.0, use_nvlamb=False,
                           clip_after_ar=True, allgather_in_fp32=True, *,
                           num_shards, axis_name=None, grad_compress=None,
                           hier_allreduce=None):
    """ZeRO LAMB as ``(init, update, step)`` for one rank of the group
    ``axis_name`` (a group or an (inner, outer) pair); it takes each
    rank's own gradients and reduces them. The knobs' contract is
    :func:`.distributed_fused_adam`'s. ``clip_after_ar`` is accepted: the
    clip is on the reduced gradients, as JAX's."""
    del clip_after_ar
    return _DistLamb(
        learning_rate, betas, eps, weight_decay, bias_correction,
        adam_w_mode, grad_averaging, max_grad_norm, use_nvlamb,
        num_shards=num_shards, axis_name=axis_name,
        grad_compress=grad_compress, hier_allreduce=hier_allreduce,
        gather_dtype=torch.float32 if allgather_in_fp32
        else torch.bfloat16).transform()


class DistributedFusedLAMB(ZeroOptimizer):
    """apex's class surface; its CUDA overlap and compression arguments
    are accepted and change nothing, except ``e5m2_allgather``, which
    gathers the update in bf16."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, eps_inside_sqrt=False,
                 weight_decay=0.01, max_grad_norm=1.0, adam_w_mode=True,
                 use_nvlamb=False, step_supports_amp_scaling=True,
                 overlap_reductions=True, dwu_group_size=0,
                 dwu_num_blocks=4, dwu_num_chunks=4, dwu_num_rs_pg=1,
                 dwu_num_ar_pg=4, dwu_num_ag_pg=0, fused_norm=False,
                 e5m2_allgather=False, verbose=False, clip_after_ar=True,
                 full_ar=False, set_param_views_to_flat_buffer=False,
                 skip_allgather=False, fuse_scale=False,
                 param_order=None, nccl_allgather_channels=0, *,
                 num_shards, axis_name=None, grad_compress=None,
                 hier_allreduce=None):
        super().__init__(params, distributed_fused_lamb(
            learning_rate=lr, betas=betas, eps=eps,
            weight_decay=weight_decay, bias_correction=bias_correction,
            adam_w_mode=adam_w_mode, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, clip_after_ar=clip_after_ar,
            allgather_in_fp32=not e5m2_allgather, num_shards=num_shards,
            axis_name=axis_name, grad_compress=grad_compress,
            hier_allreduce=hier_allreduce))
