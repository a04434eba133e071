"""Fused scale + mask + softmax over the last axis (counterpart of
``apex_tpu/ops/softmax_pallas.py``).

:func:`scaled_masked_softmax` is the one call, a ``torch.autograd.Function``:
for CUDA tensors the forward launches K10 and the backward K11
(``csrc/softmax.cu`` through :mod:`apex_tpu_torch.ops.softmax_cuda`), or
above 4096 keys their long-row forms K10L and K11L; for
CPU tensors both run the plain versions beside them,
:func:`scaled_masked_softmax_reference` (op for op with the TPU forward
kernel ``_fwd_kernel :106``) and
:func:`scaled_masked_softmax_backward_reference` (``_bwd_kernel :130``).
The JAX module's VMEM row-block model (``_sq_block``, ``block_rows``, the
dispatch table) has no counterpart here: :func:`supported` states the
CUDA kernels' own limits.

Layout: ``x`` ``[b, np, sq, sk]``; ``mask`` None or a bool/int8 tensor
that broadcasts to x along its leading axes with sk keys (nonzero =
masked out): ``[b, np, sq, sk]``, ``[b, 1, sq, sk]`` over heads, the
key-padding ``[b, 1, 1, sk]`` over heads and queries; ``causal`` masks
column > row. K10 broadcasts by index; it never expands the mask.
"""

import torch


def supported(sq, sk):
    """Whether the CUDA kernels take ``[.., sq, sk]`` rows: any row count
    and any number of keys, K10/K11 up to 4096 and K10L/K11L above (rows
    of a length that is not a multiple of the 16-byte vector take element
    loads)."""
    return sq >= 1 and sk >= 1


def mask_supported(mask, x_shape):
    """Whether ``mask`` broadcasts to ``x_shape`` along its leading axes
    with the same keys: at most 4-D, its last axis sk, each other axis 1
    or x's (the JAX kernel takes only ``[b, 1|np, sq, sk]``; K10 reads an
    axis of size 1 at stride 0)."""
    if mask.dim() > 4 or mask.dim() < 1 or mask.shape[-1] != x_shape[-1]:
        return False
    lead = (1,) * (4 - mask.dim()) + tuple(mask.shape)
    return all(m in (1, n) for m, n in zip(lead[:3], x_shape[:3]))


def scaled_masked_softmax_reference(x, mask, scale, causal):
    """The plain forward: fp32, masked positions at ``finfo(float32).min``
    before the row max and exactly 0 after the exponential, a row whose
    positions are all masked gives 0, the output in x's dtype."""
    xf = x.float() * float(scale)
    sq, sk = x.shape[-2], x.shape[-1]
    masked = None
    if mask is not None:
        masked = mask != 0
    if causal:
        tri = (torch.arange(sk, device=x.device)[None, :]
               > torch.arange(sq, device=x.device)[:, None])
        masked = tri if masked is None else masked | tri
    if masked is not None:
        xf = torch.where(masked, torch.finfo(torch.float32).min, xf)
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    if masked is not None:
        e = torch.where(masked, 0.0, e)
    s = e.sum(dim=-1, keepdim=True)
    y = torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 0.0)
    return y.to(x.dtype)


def scaled_masked_softmax_backward_reference(y, g, scale):
    """The plain backward, the softmax VJP on the saved output:
    ``dx = scale * y * (g - sum(g * y))`` in fp32, in y's dtype."""
    yf, gf = y.float(), g.float()
    dot = (yf * gf).sum(dim=-1, keepdim=True)
    return (float(scale) * yf * (gf - dot)).to(y.dtype)


def _fwd(x, mask, scale, causal):
    if x.is_cuda:
        from apex_tpu_torch.ops import softmax_cuda

        if x.shape[-1] > softmax_cuda.MAX_SK:
            return softmax_cuda.softmax_fwd_long(x, mask, scale, causal)
        return softmax_cuda.softmax_fwd(x, mask, scale, causal)
    if x.device.type != "cpu":
        raise ValueError(f"scaled_masked_softmax: no kernel for device "
                         f"{x.device}")
    return scaled_masked_softmax_reference(x, mask, scale, causal)


def _bwd(y, g, scale):
    if y.is_cuda:
        from apex_tpu_torch.ops import softmax_cuda

        if y.shape[-1] > softmax_cuda.MAX_SK:
            return softmax_cuda.softmax_bwd_long(y, g.contiguous(), scale)
        return softmax_cuda.softmax_bwd(y, g.contiguous(), scale)
    return scaled_masked_softmax_backward_reference(y, g, scale)


class _ScaledMaskedSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        y = _fwd(x, mask, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _bwd(y, g, ctx.scale), None, None, None


def scaled_masked_softmax(x, mask=None, scale=1.0, causal=False):
    """``softmax(scale * x)`` over the last axis with the causal triangle
    and/or ``mask`` masked out (layouts in the module docstring);
    differentiable in ``x``. On CUDA tensors K10 (and K11 in the
    backward) run, or K10L and K11L above 4096 keys, or the call raises;
    on CPU tensors the plain versions. Shapes the kernels do not take
    (:func:`supported`, :func:`mask_supported`) raise on either device."""
    if x.dim() != 4 or not supported(x.shape[-2], x.shape[-1]):
        raise ValueError(f"scaled_masked_softmax: x must be [b, np, sq, sk] "
                         f"with at least one key, got {tuple(x.shape)}")
    if mask is not None:
        if not mask_supported(mask, x.shape):
            raise ValueError(f"scaled_masked_softmax: mask {tuple(mask.shape)}"
                             f" does not broadcast to {tuple(x.shape)} as "
                             f"[b|1, np|1, sq|1, sk]")
        if mask.dtype not in (torch.bool, torch.int8):
            mask = mask != 0
        mask = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
        mask = mask.contiguous()
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _ScaledMaskedSoftmax.apply(x, mask, float(scale), bool(causal))
    return _fwd(x, mask, float(scale), bool(causal))
