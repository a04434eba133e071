"""The W8A16 decode matmul (counterpart of the XLA contraction in
``apex_tpu/serving/quant.py:77 qmatmul``).

:func:`qmatmul` computes ``x @ dequant(wq, scale)^T`` without a
dequantized weight: ``x`` cast to the compute dtype, the int8 ``wq``
``[N, K]`` widened, the product accumulated in fp32, the per-channel fp32
``scale`` ``[N]`` applied to the fp32 output columns, and one rounding to
the compute dtype. It dispatches on the tensor's device: CUDA launches K23
(:mod:`apex_tpu_torch.ops.qmatmul_cuda`, ``csrc/qmatmul.cu``); the CPU runs
the plain version beside it, :func:`qmatmul_reference`, which is JAX's
arithmetic op for op (an int8 value and a bf16 or fp16 value are exact in
fp32, so widening both to fp32 before the product is the same as JAX's
``dot_general`` with an fp32 result).
"""

import torch


def qmatmul_reference(x, wq, scale, compute_dtype):
    """The plain K23: ``(x.to(cd) @ wq.to(cd)^T)`` accumulated in fp32,
    times ``scale`` in fp32, rounded to ``cd`` once."""
    xc = x.to(compute_dtype).float().reshape(-1, x.shape[-1])
    y = torch.matmul(xc, wq.to(compute_dtype).float().t())
    y = (y * scale.float()).to(compute_dtype)
    return y.reshape(*x.shape[:-1], wq.shape[0])


def qmatmul(x, wq, scale, compute_dtype):
    """``x [..., K] @ dequant(wq [N, K], scale [N])^T`` in
    ``compute_dtype``: K23 on CUDA (the leading axes flattened to the
    kernel's rows), the plain version on the CPU."""
    if x.is_cuda:
        from apex_tpu_torch.ops import qmatmul_cuda

        x2 = x.to(compute_dtype).reshape(-1, x.shape[-1]).contiguous()
        y = qmatmul_cuda.qmatmul(x2, wq, scale)
        return y.reshape(*x.shape[:-1], wq.shape[0])
    return qmatmul_reference(x, wq, scale, compute_dtype)
