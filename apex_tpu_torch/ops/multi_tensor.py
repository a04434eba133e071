"""Multi-tensor ops over lists of tensors (counterpart of the jnp bodies
of ``apex_tpu/multi_tensor_apply/multi_tensor_apply.py`` and of
``apex_tpu/amp/scaler.py`` ``LossScaler.unscale``).

:func:`scale`, :func:`axpby` and :func:`l2norm` dispatch on the first
tensor's device: CUDA lists launch K12 and K13 (``csrc/multi_tensor.cu``
through :mod:`apex_tpu_torch.ops.multi_tensor_cuda`), CPU lists run the
plain versions beside them (``*_reference``), which take the JAX
functions' fp32 order: one multiply a scaled element, two products and a
sum an axpby element, per-tensor sums of squares. The optimizers' kernels
(K14, K15) are reached from ``optimizers/fused_adam.py`` and
``fused_lamb.py``, whose functional updates are their plain versions.
"""

from collections import namedtuple

import torch

Norms = namedtuple("Norms", "total per_tensor total_sq per_tensor_sq")


def scale_reference(srcs, out_dtypes, factor, check_input=False,
                    flag_dtype=torch.int32):
    """The plain K12: ``srcs[i].float() * factor`` cast to
    ``out_dtypes[i]``, and the flag set when an input (``check_input``) or
    an fp32 product is not finite."""
    prods = torch._foreach_mul([s.float() for s in srcs], factor)
    checked = srcs if check_input else prods
    finite = torch.stack([torch.isfinite(t).all() for t in checked]).all()
    return ([p.to(dt) for p, dt in zip(prods, out_dtypes)],
            (~finite).to(flag_dtype))


def axpby_reference(xs, ys, out_dtypes, a, b, flag_dtype=torch.int32):
    """The plain axpby: ``a * x + b * y`` in fp32, the flag set when a sum
    is not finite."""
    outs = torch._foreach_add(
        torch._foreach_mul([x.float() for x in xs], float(a)),
        torch._foreach_mul([y.float() for y in ys], float(b)))
    finite = torch.stack([torch.isfinite(t).all() for t in outs]).all()
    return ([o.to(dt) for o, dt in zip(outs, out_dtypes)],
            (~finite).to(flag_dtype))


def l2norm_reference(tensors, max_mode=False):
    """The plain K13: each tensor's fp32 sum of squares (or largest
    magnitude), its square root, and the list's (the tensors' values
    stacked and summed, or their max). Returns :class:`Norms`."""
    if max_mode:
        per = torch.stack([t.float().abs().amax() if t.numel()
                           else t.new_zeros((), dtype=torch.float32)
                           for t in tensors])
        total = per.max()
        return Norms(total, per, total, per)
    per_sq = torch.stack([torch.sum(torch.square(t.float()))
                          for t in tensors])
    total_sq = torch.sum(per_sq)
    return Norms(torch.sqrt(total_sq), torch.sqrt(per_sq), total_sq, per_sq)


def scale(srcs, out_dtypes, factor, check_input=False,
          flag_dtype=torch.int32):
    """``(outs, flag)``: ``srcs[i] * factor`` in fp32 cast to
    ``out_dtypes[i]``, and a 0-d ``flag_dtype`` flag set when an input
    (``check_input``) or an fp32 product is not finite; K12 on CUDA."""
    if srcs[0].is_cuda:
        from apex_tpu_torch.ops import multi_tensor_cuda

        return multi_tensor_cuda.scale(srcs, out_dtypes, factor, check_input,
                                       flag_dtype)
    return scale_reference(srcs, out_dtypes, factor, check_input, flag_dtype)


def axpby(xs, ys, out_dtypes, a, b, flag_dtype=torch.int32):
    """``(outs, flag)``: ``a * xs[i] + b * ys[i]`` in fp32 cast to
    ``out_dtypes[i]``, the flag set when a sum is not finite; K12 on
    CUDA."""
    if xs[0].is_cuda:
        from apex_tpu_torch.ops import multi_tensor_cuda

        return multi_tensor_cuda.axpby(xs, ys, out_dtypes, a, b, flag_dtype)
    return axpby_reference(xs, ys, out_dtypes, a, b, flag_dtype)


def l2norm(tensors, max_mode=False):
    """Per-tensor and total L2 norms (or largest magnitudes) as
    :class:`Norms`; K13 on CUDA."""
    if tensors[0].is_cuda:
        from apex_tpu_torch.ops import multi_tensor_cuda

        return multi_tensor_cuda.l2norm(tensors, max_mode)
    return l2norm_reference(tensors, max_mode)
