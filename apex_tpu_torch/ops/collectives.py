"""The int8 block codec of the collectives layer (counterpart of the jnp
bodies of ``apex_tpu/parallel/collectives.py:269 quantize_blocks``,
``:304 dequantize_blocks``, ``:311 _compensate`` and the fp32 sums of
``:354-360`` and ``:384-387``).

:func:`quantize` is K19: the compensated input ``comp = x + residual``
(fp32), each ``block``-element block's largest magnitude ``amax``, the
bf16 scale ``bf16(amax / 127)`` (1 where amax is 0, inf where it is not
finite), ``q = clip(rint(comp / f32(scale)), -127, 127)`` as int8 (0
where the quotient is NaN, as XLA's cast gives it), and the new residual
``where(isfinite(dq), comp - dq, 0)`` with ``dq = f32(q) * f32(scale)``.
Rows ``[R, n]`` are padded to a block multiple each, with zeros.
:func:`dequantize_sum` is K20: ``[W, nb, block]`` int8 with ``[W, nb]``
bf16 scales dequantized and summed over W in rank order into ``[n]``
fp32 (then divided by ``divisor`` when given, a true division), or, with
``gather=True``, each rank's first ``n`` values concatenated into
``[W n]``.

Both dispatch on the input's device: CUDA tensors launch the kernels
(``csrc/collectives.cu`` through :mod:`apex_tpu_torch.ops.
collectives_cuda`), CPU tensors run the plain versions beside them
(``*_reference``), which are JAX's functions op for op, so that on the
CPU the codec equals JAX's bit for bit. Divisions are by 0-d tensors on
the input's device: PyTorch turns a division of a CUDA tensor by a host
number into a multiplication by its reciprocal.
"""

import torch

from apex_tpu_torch import device_scalar

DEFAULT_BLOCK = 128


def quantize_reference(x, residual=None, *, block=DEFAULT_BLOCK):
    """The plain K19 over ``x`` ``[..., n]``: returns ``(q [..., nb,
    block] int8, scales [..., nb] bf16, new_residual)``, the new residual
    None without ``residual``."""
    comp = x if residual is None else x + residual
    n = comp.shape[-1]
    nb = -(-n // block)
    xf = comp.float()
    if nb * block != n:
        xf = torch.nn.functional.pad(xf, (0, nb * block - n))
    xb = xf.reshape(*comp.shape[:-1], nb, block)
    amax = torch.amax(torch.abs(xb), dim=-1)
    scales = torch.where(amax > 0, amax / device_scalar(127.0, amax), 1.0)
    scales = torch.where(torch.isfinite(amax), scales,
                         torch.inf).to(torch.bfloat16)
    quot = torch.round(xb / scales.float()[..., None])
    quot = torch.where(torch.isnan(quot), 0.0, quot)
    q = torch.clamp(quot, -127, 127).to(torch.int8)
    if residual is None:
        return q, scales, None
    dq = dequantize_reference(q, scales, n)
    return q, scales, torch.where(torch.isfinite(dq), comp - dq, 0.0)


def dequantize_reference(q, scales, n):
    """JAX's ``dequantize_blocks``: ``[..., nb, block]`` int8 and ``[...,
    nb]`` bf16 scales to ``[..., n]`` fp32."""
    xb = q.float() * scales.float()[..., None]
    return xb.reshape(*q.shape[:-2], -1)[..., :n]


def dequantize_sum_reference(q, scales, n, *, gather=False, divisor=None):
    """The plain K20 over ``q`` ``[W, nb, block]`` and ``scales`` ``[W,
    nb]``: the sum over W in rank order of the dequantized rows, sliced
    to ``n`` and divided by ``divisor`` (a number, or None); with
    ``gather`` each row's first ``n`` values concatenated, ``[W n]``."""
    dq = dequantize_reference(q, scales, n)
    if gather:
        return dq.reshape(-1)
    total = dq[0]
    for w in range(1, dq.shape[0]):
        total = total + dq[w]
    if divisor is not None:
        total = total / device_scalar(divisor, total)
    return total


def quantize(x, residual=None, *, block=DEFAULT_BLOCK):
    """K19 on CUDA, else :func:`quantize_reference` (same contract):
    ``x`` fp32 ``[R, n]`` or ``[n]``."""
    if x.is_cuda:
        from apex_tpu_torch.ops import collectives_cuda

        return collectives_cuda.quantize(x, residual, block=block)
    return quantize_reference(x, residual, block=block)


def dequantize_sum(q, scales, n, *, gather=False, divisor=None):
    """K20 on CUDA, else :func:`dequantize_sum_reference`."""
    if q.is_cuda:
        from apex_tpu_torch.ops import collectives_cuda

        return collectives_cuda.dequantize_sum(q, scales, n, gather=gather,
                                               divisor=divisor)
    return dequantize_sum_reference(q, scales, n, gather=gather,
                                    divisor=divisor)
