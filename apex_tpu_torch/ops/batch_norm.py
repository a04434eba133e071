"""Batch norm over rows, synced or local (counterpart of
``apex_tpu/parallel/sync_batchnorm.py:23 sync_batch_norm``'s arithmetic).

The function works on a 2-D view ``[M, C]`` of the activation, channels
innermost in memory (NHWC, or NCHW in ``torch.channels_last``), in two
stages each way, with the all-reduce between them when the process group
has more than one rank:

- forward: stage 1 (:func:`fwd_stats`) the fp32 sums of x and x^2 and
  the row count ``[2C + 1]``; stage 2 (:func:`fwd_apply`) mean = s / n,
  var = max(ss / n - mean^2, 0), rstd = rsqrt(var + eps), the running
  stats updated in place (the variance unbiased, var n / max(n - 1, 1)),
  and y = ((x - mean) rstd) scale + bias, optionally ReLU, in x's dtype;
- backward: stage 1 (:func:`bwd_stats`) the per-channel sums of g (the
  output gradient, masked where a fused ReLU's output is not positive)
  and of g xhat, which are also dbias and dscale; stage 2
  (:func:`bwd_apply`) dx = (scale rstd) ((g - sum_g / n) - xhat (sum_gx /
  n)), the closed form of JAX's autodiff through ``psum`` with the two
  sums all-reduced.

Each stage dispatches on the tensor's device: CUDA launches K17 (stage 1
and 2 of the forward) or K18 (of the backward) through
:mod:`apex_tpu_torch.ops.batch_norm_cuda`, the CPU runs the plain version
beside it (``*_reference``). Where no all-reduce sits between the stages
(the group has one rank) both stages run as one (:func:`fwd`,
:func:`bwd`: one launch each on CUDA); a group of ranks takes the two
stages with the all-reduce between them. :class:`BatchNormFunction` puts
the stages behind one ``torch.autograd.Function`` and chooses the form by
the group's size alone.

``flax_running=True`` keeps the running stats in flax's ``nn.BatchNorm``
convention instead (the JAX package's DCGAN): ``running = momentum *
running + (1 - momentum) * batch`` with the biased variance, taken from
stage 1's ``[sum x, sum x^2, n]`` after stage 2 (which then updates
nothing) by :func:`flax_running_update`, with stage 2's own arithmetic.
"""

import torch
import torch.distributed as dist


def _fp32_params(weight, bias):
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return w, b


def fwd_stats_reference(x2d):
    """The plain K17 stage 1: ``[sum x, sum x^2, n]`` in fp32."""
    xf = x2d.float()
    n = torch.full((1,), float(x2d.shape[0]), dtype=torch.float32,
                   device=x2d.device)
    return torch.cat([xf.sum(0), (xf * xf).sum(0), n])


def fwd_apply_reference(x2d, stats, weight, bias, running_mean, running_var,
                        eps, momentum, training, fuse_relu):
    """The plain K17 stage 2: ``(y, mean, rstd)``; the running stats (fp32,
    or None) updated in place in training."""
    c = x2d.shape[1]
    if training:
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        if running_mean is not None:
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            running_mean.copy_((1 - momentum) * running_mean
                               + momentum * mean)
            running_var.copy_((1 - momentum) * running_var
                              + momentum * unbiased)
    else:
        mean, var = running_mean.clone(), running_var
    rstd = torch.rsqrt(var + eps)
    w, b = _fp32_params(weight, bias)
    y = (x2d.float() - mean) * rstd
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    if fuse_relu:
        y = torch.relu(y)
    return y.to(x2d.dtype), mean, rstd


def flax_running_update(stats, running_mean, running_var, momentum):
    """Flax's running-stat update in place from stage 1's ``stats``: mean
    ``s / n``, the biased variance ``max(ss / n - mean^2, 0)`` (true
    divisions by the 0-d count, as stage 2 divides), then ``momentum *
    running + (1 - momentum) * batch``."""
    c = running_mean.shape[0]
    n = stats[2 * c]
    mean = stats[:c] / n
    var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
    running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1 - momentum) * var)


def _xhat_and_g(x2d, dy2d, mean, rstd, weight, bias, fuse_relu):
    xhat = (x2d.float() - mean) * rstd
    g = dy2d.float()
    if fuse_relu:
        w, b = _fp32_params(weight, bias)
        y = xhat if w is None else xhat * w
        if b is not None:
            y = y + b
        g = torch.where(y > 0, g, torch.zeros_like(g))
    return xhat, g


def bwd_stats_reference(x2d, dy2d, mean, rstd, weight, bias, fuse_relu):
    """The plain K18 stage 1: ``[sum g, sum g xhat]`` in fp32."""
    xhat, g = _xhat_and_g(x2d, dy2d, mean, rstd, weight, bias, fuse_relu)
    return torch.cat([g.sum(0), (g * xhat).sum(0)])


def bwd_apply_reference(x2d, dy2d, mean, rstd, weight, bias, sums, stats,
                        training, fuse_relu):
    """The plain K18 stage 2: dx in x's dtype (``sums`` all-reduced, ``n``
    the forward's ``stats[2C]``; in eval dx = scale rstd g)."""
    c = x2d.shape[1]
    xhat, g = _xhat_and_g(x2d, dy2d, mean, rstd, weight, bias, fuse_relu)
    k = rstd if weight is None else weight.float() * rstd
    if training:
        n = stats[2 * c]
        g = (g - sums[:c] / n) - xhat * (sums[c:] / n)
    return (k * g).to(x2d.dtype)


def fwd_reference(x2d, weight, bias, running_mean, running_var, eps,
                  momentum, fuse_relu):
    """The plain one-launch K17 (training): stage 1, then stage 2 on its
    stats; ``(y, mean, rstd, stats)``."""
    stats = fwd_stats_reference(x2d)
    y, mean, rstd = fwd_apply_reference(x2d, stats, weight, bias,
                                        running_mean, running_var, eps,
                                        momentum, True, fuse_relu)
    return y, mean, rstd, stats


def bwd_reference(x2d, dy2d, mean, rstd, weight, bias, stats, training,
                  fuse_relu):
    """The plain one-launch K18: stage 1, then stage 2 on its sums;
    ``(dx, sums)``."""
    sums = bwd_stats_reference(x2d, dy2d, mean, rstd, weight, bias,
                               fuse_relu)
    dx = bwd_apply_reference(x2d, dy2d, mean, rstd, weight, bias, sums,
                             stats, training, fuse_relu)
    return dx, sums


def fwd_stats(x2d):
    """Stage 1 of the forward (K17 on CUDA)."""
    if x2d.is_cuda:
        from apex_tpu_torch.ops import batch_norm_cuda

        return batch_norm_cuda.fwd_stats(x2d)
    return fwd_stats_reference(x2d)


def fwd_apply(x2d, stats, weight, bias, running_mean, running_var, eps,
              momentum, training, fuse_relu):
    """Stage 2 of the forward (K17 on CUDA)."""
    if x2d.is_cuda:
        from apex_tpu_torch.ops import batch_norm_cuda

        return batch_norm_cuda.fwd_apply(x2d, stats, weight, bias,
                                         running_mean, running_var, eps,
                                         momentum, training, fuse_relu)
    return fwd_apply_reference(x2d, stats, weight, bias, running_mean,
                               running_var, eps, momentum, training,
                               fuse_relu)


def bwd_stats(x2d, dy2d, mean, rstd, weight, bias, fuse_relu):
    """Stage 1 of the backward (K18 on CUDA)."""
    if x2d.is_cuda:
        from apex_tpu_torch.ops import batch_norm_cuda

        return batch_norm_cuda.bwd_stats(x2d, dy2d, mean, rstd, weight, bias,
                                         fuse_relu)
    return bwd_stats_reference(x2d, dy2d, mean, rstd, weight, bias,
                               fuse_relu)


def bwd_apply(x2d, dy2d, mean, rstd, weight, bias, sums, stats, training,
              fuse_relu):
    """Stage 2 of the backward (K18 on CUDA)."""
    if x2d.is_cuda:
        from apex_tpu_torch.ops import batch_norm_cuda

        return batch_norm_cuda.bwd_apply(x2d, dy2d, mean, rstd, weight, bias,
                                         sums, stats, training, fuse_relu)
    return bwd_apply_reference(x2d, dy2d, mean, rstd, weight, bias, sums,
                               stats, training, fuse_relu)


def fwd(x2d, weight, bias, running_mean, running_var, eps, momentum,
        fuse_relu):
    """The training forward on one rank, both stages at once (K17 in one
    launch on CUDA): ``(y, mean, rstd, stats)``."""
    if x2d.is_cuda:
        from apex_tpu_torch.ops import batch_norm_cuda

        return batch_norm_cuda.fwd(x2d, weight, bias, running_mean,
                                   running_var, eps, momentum, fuse_relu)
    return fwd_reference(x2d, weight, bias, running_mean, running_var, eps,
                         momentum, fuse_relu)


def bwd(x2d, dy2d, mean, rstd, weight, bias, stats, training, fuse_relu):
    """The backward on one rank, both stages at once (K18 in one launch on
    CUDA): ``(dx, sums)``."""
    if x2d.is_cuda:
        from apex_tpu_torch.ops import batch_norm_cuda

        return batch_norm_cuda.bwd(x2d, dy2d, mean, rstd, weight, bias,
                                   stats, training, fuse_relu)
    return bwd_reference(x2d, dy2d, mean, rstd, weight, bias, stats,
                         training, fuse_relu)


def group_size(group):
    """The ranks of ``group`` (None: no group, 1)."""
    if group is None or not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


class BatchNormFunction(torch.autograd.Function):
    """y2d of ``batch_norm_rows``; the gradients of x, scale and bias
    (scale's and bias's the rank-local sums, cast to their dtypes, as
    JAX's transpose of the fp32 upcast gives them)."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, running_mean, running_var, eps,
                momentum, training, fuse_relu, group, flax_running=False):
        stats = None
        flax = training and flax_running and running_mean is not None
        rm, rv = (None, None) if flax else (running_mean, running_var)
        synced = group_size(group) > 1
        if training and not synced:
            y, mean, rstd, stats = fwd(x2d, weight, bias, rm, rv, eps,
                                       momentum, fuse_relu)
        else:
            if training:
                stats = fwd_stats(x2d)
                dist.all_reduce(stats, group=group)
            y, mean, rstd = fwd_apply(x2d, stats, weight, bias, rm, rv, eps,
                                      momentum, training, fuse_relu)
        if flax:
            flax_running_update(stats, running_mean, running_var, momentum)
        ctx.save_for_backward(x2d, weight, bias, mean, rstd, stats)
        ctx.flags = (training, fuse_relu, group)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, bias, mean, rstd, stats = ctx.saved_tensors
        training, fuse_relu, group = ctx.flags
        c = x2d.shape[1]
        dy = dy.contiguous()
        synced = training and group_size(group) > 1
        if synced:
            sums = bwd_stats(x2d, dy, mean, rstd, weight, bias, fuse_relu)
        else:
            dx, sums = bwd(x2d, dy, mean, rstd, weight, bias, stats,
                           training, fuse_relu)
        dweight = dbias = None
        if weight is not None and ctx.needs_input_grad[1]:
            dweight = sums[c:].to(weight.dtype, copy=True)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = sums[:c].to(bias.dtype, copy=True)
        if synced:
            dist.all_reduce(sums, group=group)
            dx = bwd_apply(x2d, dy, mean, rstd, weight, bias, sums, stats,
                           training, fuse_relu)
        return (dx, dweight, dbias) + (None,) * 8


def batch_norm_rows(x2d, weight, bias, running_mean=None, running_var=None,
                    eps=1e-5, momentum=0.1, training=True, fuse_relu=False,
                    group=None, flax_running=False):
    """Batch norm of a contiguous ``[M, C]`` tensor over its rows (and over
    ``group``'s ranks in training), differentiable in x, weight and bias;
    the running stats (fp32 ``[C]``, or None) updated in place in
    training, in PyTorch's convention or, with ``flax_running``, in
    flax's (``momentum`` is then flax's, the share the old value keeps)."""
    if not training and (running_mean is None or running_var is None):
        raise ValueError(
            "batch norm with training=False needs running_mean and "
            "running_var; without tracked stats evaluate with batch "
            "statistics (training=True)")
    return BatchNormFunction.apply(x2d, weight, bias, running_mean,
                                   running_var, eps, momentum, training,
                                   fuse_relu, group, flax_running)
