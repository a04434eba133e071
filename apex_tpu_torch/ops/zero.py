"""The ZeRO optimizers' shard updates (counterpart of the jnp bodies of
``apex_tpu/contrib/optimizers/distributed_fused_adam.py:101-126`` and
``distributed_fused_lamb.py:117-149``), on one rank's fp32 shard of the
flat parameters.

:func:`adam` is K21: ``_adam_flat`` on the shard (the update ``u = -lr *
update``), ``m`` and ``v`` in place and ``master += u``. :func:`lamb_stage1`
and :func:`lamb_stage2` are K22: stage 1 clips the gradient by the
all-reduced global norm, writes ``m`` and ``v`` (``beta3 = 1 - beta1``
under ``grad_averaging``) and returns the direction ``u`` and each
segment's sums of ``p * p`` and ``u * u`` over the shard (``[2, N + 1]``,
the padding segment N last) for the caller to all-reduce; stage 2 takes
the trust ratio of each tensor from those sums (``|p| / (|u| + 1e-38)``
where both are positive, else 1; 1 for the padding; all ones unless
``trust``) and writes ``u = (-lr * ratio) * u`` and ``master += u``. Where
the 0-d bool ``skip`` (the found-inf flag) is set, nothing of the state is
written (``m``, ``v``, ``master``, the count), but the update is, because
every rank all-gathers it on a skipped step too.

Each dispatches on the gradient's device: CUDA shards launch the kernels
(``csrc/multi_tensor.cu`` through ``ops/multi_tensor_cuda.zero_adam``,
``zero_lamb_stage1``, ``zero_lamb_stage2``), CPU shards run the plain
versions beside them (``*_reference``). The plain K21 is
``optimizers/fused_adam._adam_flat`` on the shard, so K21 equals it bit
for bit; the plain K22 sums each segment with ``torch.sum``
(``ShardLayout.segment_sums``), the kernel by pieces and then the pieces
in order: both in a fixed order, within a band of each other.
"""

import torch

from apex_tpu_torch import device_scalar


def _select(pairs, skip):
    for old, new in pairs:
        old.copy_(new if skip is None else torch.where(skip, old, new))


def adam_reference(g, master, m, v, count, count_new, bc1, bc2, lr, *, beta1,
                   beta2, eps, weight_decay, adam_w_mode, bias_correction,
                   skip=None):
    """The plain K21 (``bc1`` and ``bc2`` are recomputed from
    ``count_new`` by ``_adam_flat``, as the caller computed them)."""
    from apex_tpu_torch.optimizers.fused_adam import _adam_flat

    us, ms, vs = _adam_flat([g], [master], [m], [v], count_new, lr, beta1,
                            beta2, eps, weight_decay, adam_w_mode,
                            bias_correction)
    u = us[0]
    _select(((m, ms[0]), (v, vs[0]), (master, master + u),
             (count, count_new)), skip)
    return u


def adam(g, master, m, v, count, count_new, bc1, bc2, lr, **kw):
    """K21 on CUDA, else :func:`adam_reference`: returns the update."""
    if g.is_cuda:
        from apex_tpu_torch.ops import multi_tensor_cuda

        return multi_tensor_cuda.zero_adam(g, master, m, v, count, count_new,
                                           bc1, bc2, lr, **kw)
    return adam_reference(g, master, m, v, count, count_new, bc1, bc2, lr,
                          **kw)


def lamb_stage1_reference(g, master, m, v, layout, count, count_new, bc1, bc2,
                          *, beta1, beta2, beta3, eps, weight_decay,
                          adam_w_mode, bias_correction, max_grad_norm,
                          global_sq=None, skip=None):
    """The plain K22 stage 1: returns ``(u, sums [2, N + 1])``."""
    if max_grad_norm is not None and max_grad_norm > 0:
        clip = torch.clamp(torch.sqrt(global_sq) / device_scalar(max_grad_norm, g),
                           min=1.0)
        g = g / clip
    p = master
    g_eff = g if adam_w_mode else g + weight_decay * p
    new_m = beta1 * m + beta3 * g_eff
    new_v = beta2 * v + (1.0 - beta2) * g_eff * g_eff
    if bias_correction:
        u = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
    else:
        u = new_m / (torch.sqrt(new_v) + eps)
    if adam_w_mode:
        u = u + weight_decay * p
    sums = torch.stack([layout.segment_sums(p * p),
                        layout.segment_sums(u * u)])
    _select(((m, new_m), (v, new_v), (count, count_new)), skip)
    return u, sums


def lamb_stage2_reference(u, master, sums, layout, lr, *, trust, skip=None):
    """The plain K22 stage 2: ``u`` becomes the update, in place."""
    n = layout.num_tensors
    w, un = torch.sqrt(sums[0, :n]), torch.sqrt(sums[1, :n])
    ratio = torch.where((w > 0) & (un > 0), w / (un + 1e-38), 1.0)
    if not trust:
        ratio = torch.ones_like(ratio)
    ratio = torch.cat([ratio, torch.ones(1, dtype=ratio.dtype,
                                         device=ratio.device)])
    neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
    upd = neg_lr * layout.per_element(ratio) * u
    _select(((master, master + upd),), skip)
    u.copy_(upd)
    return u


def lamb_stage1(g, master, m, v, layout, count, count_new, bc1, bc2, **kw):
    """K22 stage 1 on CUDA, else :func:`lamb_stage1_reference`."""
    if g.is_cuda:
        from apex_tpu_torch.ops import multi_tensor_cuda

        return multi_tensor_cuda.zero_lamb_stage1(
            g, master, m, v, layout, count, count_new, bc1, bc2, **kw)
    return lamb_stage1_reference(g, master, m, v, layout, count, count_new,
                                 bc1, bc2, **kw)


def lamb_stage2(u, master, sums, layout, lr, **kw):
    """K22 stage 2 on CUDA, else :func:`lamb_stage2_reference`."""
    if u.is_cuda:
        from apex_tpu_torch.ops import multi_tensor_cuda

        return multi_tensor_cuda.zero_lamb_stage2(u, master, sums, layout,
                                                  lr, **kw)
    return lamb_stage2_reference(u, master, sums, layout, lr, **kw)
