"""Row layer norm with a hand-written backward (counterpart of
``apex_tpu/ops/layer_norm_pallas.py``).

* :func:`layer_norm_fwd` / :func:`layer_norm_bwd` are the plain versions,
  op for op with the TPU kernels ``_fwd_kernel :102`` and ``_bwd_kernel
  :122`` over all rows at once: fp32 statistics (the mean, then the mean
  of the centred squares), ``rstd = rsqrt(var + eps)``, fp32 affine, the
  output in x's dtype; the backward recomputes ``xhat`` from the saved
  fp32 ``[rows]`` mean and rstd.
* :func:`layer_norm` is the ``torch.autograd.Function`` around them. It
  saves x, the weight, mean and rstd, as ``_fwd :205`` does. For a CUDA
  tensor it runs K3 and K4 (:mod:`apex_tpu_torch.ops.layer_norm_cuda`;
  K4's second stage sums the affine-gradient partials over blocks, as
  JAX sums them outside its kernel at ``:244-245``); for a CPU tensor it
  runs the plain versions. There is no fallback from one to the other;
  the kernels take every width.
"""

import torch

from apex_tpu_torch.ops import layer_norm_cuda


def layer_norm_fwd(x2d, weight, bias, eps):
    """``(y, mean, rstd)`` for ``x2d [rows, hidden]``; ``weight`` and
    ``bias`` are ``[hidden]`` or None."""
    x = x2d.float()
    mean = x.mean(dim=1)
    xc = x - mean[:, None]
    var = (xc * xc).mean(dim=1)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd[:, None]
    if weight is not None:
        y = y * weight.float()[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(x2d.dtype), mean, rstd


def layer_norm_bwd(x2d, weight, mean, rstd, dy):
    """``(dx, dw, db)``: dx in x's dtype, the affine gradients fp32
    ``[hidden]`` (summed over every row)."""
    x = x2d.float()
    g = dy.float()
    xhat = (x - mean[:, None]) * rstd[:, None]
    wg = g * weight.float()[None, :] if weight is not None else g
    m1 = wg.mean(dim=1)
    m2 = (wg * xhat).mean(dim=1)
    dx = (wg - m1[:, None] - xhat * m2[:, None]) * rstd[:, None]
    return dx.to(x2d.dtype), (g * xhat).sum(dim=0), g.sum(dim=0)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, bias, eps):
        if x2d.is_cuda:
            y, mean, rstd = layer_norm_cuda.layer_norm_fwd(x2d, weight, bias,
                                                           eps)
        elif x2d.device.type == "cpu":
            y, mean, rstd = layer_norm_fwd(x2d, weight, bias, eps)
        else:
            raise ValueError(f"layer_norm: no kernel for device "
                             f"{x2d.device}")
        ctx.save_for_backward(x2d, weight, mean, rstd)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if x2d.is_cuda:
            dx, dw, db = layer_norm_cuda.layer_norm_bwd(x2d, weight, mean,
                                                        rstd, dy)
        else:
            dx, dw, db = layer_norm_bwd(x2d, weight, mean, rstd, dy)
        return (dx, dw if weight is not None else None,
                db if ctx.has_bias else None, None)


def layer_norm(x2d, weight, bias, eps=1e-5):
    """Row layer norm over the last dim of a contiguous ``x2d [rows,
    hidden]``, differentiable in x, weight and bias (fp32 ``[hidden]``
    or None). Output in ``x2d.dtype``."""
    return _LayerNorm.apply(x2d, weight, bias, float(eps))
