"""Cross-replica batch norm (counterpart of
``apex_tpu/parallel/sync_batchnorm.py``).

:func:`sync_batch_norm` is JAX's function over a ``torch.distributed``
process group instead of a mesh axis: fp32 sums of x and x^2 all-reduced
with the count between the forward's two stages (K17 on the card), the
running stats updated with the unbiased variance, the output in x's
dtype; in training its backward all-reduces the per-channel sums of g
and g xhat between its two stages (K18), which is what JAX's autodiff
through ``psum`` gives. ``process_group=None`` is local batch norm (JAX's
``axis_name=None``), as is a group of one rank.

The kernels read the activation as ``[M, C]`` rows with the channel axis
innermost in memory: NHWC with ``channel_axis=-1``, or NCHW in
``torch.channels_last`` with ``channel_axis=1``, the port's ResNet
layout; either is a view, no copy. Any other layout (channels-first
memory, JAX's ``channel_last=False`` on a contiguous NCHW tensor) runs on
a channels-last copy here. :class:`SyncBatchNorm`, the module, raises
instead of copying a 4-D channels-first activation on the card, where a
quiet copy would cost the step a pass.
"""

import torch
from torch import nn

from apex_tpu_torch import default_device
from apex_tpu_torch.ops import batch_norm


def sync_batch_norm(x, scale, bias, process_group=None, eps=1e-5,
                    momentum=0.1, running_mean=None, running_var=None,
                    training=True, channel_axis=-1, fuse_relu=False):
    """Synced batch norm over ``process_group`` (None: local). Returns
    ``(y, running_mean, running_var)``: the running stats (fp32, or None)
    are updated in place in training and returned; eval
    (``training=False``) normalizes with them and needs them."""
    if not training and (running_mean is None or running_var is None):
        raise ValueError(
            "sync_batch_norm(training=False) requires running_mean and "
            "running_var; with track_running_stats=False evaluate with "
            "batch statistics (training=True)")
    axis = channel_axis % x.dim()
    xt = x.movedim(axis, -1)
    if not xt.is_contiguous():
        xt = xt.contiguous()
    c = xt.shape[-1]
    y2d = batch_norm.batch_norm_rows(
        xt.reshape(-1, c), scale, bias, running_mean, running_var, eps,
        momentum, training, fuse_relu, process_group)
    y = y2d.view(xt.shape).movedim(-1, axis)
    return y, running_mean, running_var


class SyncBatchNorm(nn.Module):
    """apex's ``SyncBatchNorm`` as a module: ``weight`` and ``bias``
    parameters (fp32, ones and zeros; each kept where ``use_scale`` /
    ``use_bias``, default ``affine``), ``running_mean`` and
    ``running_var`` buffers (fp32) when ``track_running_stats``.
    ``channel_last`` picks the channel axis, -1 (JAX's default) or 1
    (NCHW, which on the card must be in ``torch.channels_last`` memory);
    ``process_group`` the ranks the statistics are synced over (None:
    local). In training mode (or ``use_running_average=False``), or
    without tracked stats, it normalizes with batch statistics, as apex
    does."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None,
                 channel_last=True, fuse_relu=False, use_scale=None,
                 use_bias=None, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.use_scale = affine if use_scale is None else use_scale
        self.use_bias = affine if use_bias is None else use_bias
        self.track_running_stats = track_running_stats
        self.process_group = process_group
        self.channel_last = channel_last
        self.fuse_relu = fuse_relu
        self.weight = nn.Parameter(torch.ones(
            num_features, dtype=dtype, device=device)) \
            if self.use_scale else None
        self.bias = nn.Parameter(torch.zeros(
            num_features, dtype=dtype, device=device)) \
            if self.use_bias else None
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(
                num_features, dtype=torch.float32, device=device))
            self.register_buffer("running_var", torch.ones(
                num_features, dtype=torch.float32, device=device))
        else:
            self.running_mean = self.running_var = None

    def forward(self, x, use_running_average=None):
        """``use_running_average`` (flax's argument) overrides the
        module's mode for this call: None follows ``self.training``."""
        axis = -1 if self.channel_last else 1
        if (x.is_cuda and x.dim() == 4 and not self.channel_last
                and not x.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(
                "SyncBatchNorm(channel_last=False) on the card reads NCHW "
                "activations in torch.channels_last memory; got a "
                f"{tuple(x.shape)} tensor with strides {x.stride()} (a "
                "layer before it returned channels-first memory)")
        if use_running_average is None:
            use_running_average = not self.training
        training = not use_running_average or not self.track_running_stats
        y, _, _ = sync_batch_norm(
            x, self.weight, self.bias, self.process_group, self.eps,
            self.momentum,
            self.running_mean if self.track_running_stats else None,
            self.running_var if self.track_running_stats else None,
            training, axis, self.fuse_relu)
        return y

    def extra_repr(self):
        return (f"{self.num_features}, eps={self.eps}, "
                f"momentum={self.momentum}, channel_last={self.channel_last}"
                f", fuse_relu={self.fuse_relu}")


def convert_syncbn_model(module, process_group=None, channel_last=False):
    """Every ``nn.BatchNorm*d`` under ``module`` replaced by a
    ``SyncBatchNorm`` over ``process_group`` with its parameters and
    running stats (PyTorch's momentum is the same convention as apex's);
    the module itself returned if it is one."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        dev = (module.weight.device if module.weight is not None
               else module.running_mean.device)
        out = SyncBatchNorm(module.num_features, eps=module.eps,
                            momentum=module.momentum, affine=module.affine,
                            track_running_stats=module.track_running_stats,
                            process_group=process_group,
                            channel_last=channel_last, device=dev)
        with torch.no_grad():
            if module.affine:
                out.weight.copy_(module.weight)
                out.bias.copy_(module.bias)
            if module.track_running_stats:
                out.running_mean.copy_(module.running_mean)
                out.running_var.copy_(module.running_var)
        out.train(module.training)
        return out
    for name, child in module.named_children():
        new = convert_syncbn_model(child, process_group, channel_last)
        if new is not child:
            setattr(module, name, new)
    return module


def create_syncbn_process_group(group_size):
    """Partition the default group's ranks into consecutive groups of
    ``group_size`` and return this rank's (every rank must call it, as
    ``torch.distributed.new_group`` requires): the default group when the
    size is the world's, None in a world of one rank."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if group_size == 0 or world % group_size != 0:
        raise ValueError(
            f"group_size {group_size} must divide world size {world}")
    if group_size == world:
        return dist.group.WORLD if world > 1 else None
    rank = dist.get_rank()
    mine = None
    for start in range(0, world, group_size):
        g = dist.new_group(list(range(start, start + group_size)))
        if start <= rank < start + group_size:
            mine = g
    return mine
