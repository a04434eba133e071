"""Tensor-parallel layers at tp=1 (counterpart of
``apex_tpu/transformer/tensor_parallel/layers.py``).

The port runs on one card, so the collectives of the JAX package's
mappings are identities here and the modules hold the whole weight. The
weight layout stays the JAX (and Megatron) one, ``[out, in]``, so one
parameter tree serves both packages. A tensor-parallel size above 1 and
sequence parallelism raise.

* :func:`_mm` — ``x @ w^T`` in x's dtype (the JAX package's amp compute
  dtype with no policy active), fp32 accumulation, rounded once.
* :func:`vocab_parallel_embed` — the row lookup (``jnp.take``).
* :class:`ColumnParallelLinear`, :class:`RowParallelLinear` — ``Y = X
  W^T + b`` with ``skip_bias_add`` returning ``(Y, b)``; parameters fp32
  (``params_dtype``), cast to the input dtype per call.
"""

import math

import torch
from torch import nn

from apex_tpu_torch import default_device


def _mm(x, w):
    """``x @ w^T`` in x's dtype with fp32 accumulation, rounded to x's
    dtype (half-precision products accumulate in fp32 in cuBLAS and on
    the CPU alike; fp32 runs in full fp32 with TF32 off)."""
    return torch.matmul(x, w.to(x.dtype).t())


def vocab_parallel_embed(weight, input_ids):
    """Rows of ``weight`` at ``input_ids`` (the tp=1 branch of the JAX
    function: a plain lookup, in the table's dtype)."""
    return weight[input_ids]


def check_single_rank(tp_size=1, sequence_parallel=False):
    if tp_size != 1:
        raise ValueError(f"tensor-parallel size {tp_size}: the port runs "
                         f"tp=1 only")
    if sequence_parallel:
        raise ValueError("sequence parallelism is not ported")


class _ParallelLinear(nn.Module):
    def __init__(self, input_size, output_size, bias=True, skip_bias_add=False,
                 init_std=0.02, params_dtype=torch.float32, tp_size=1,
                 sequence_parallel_enabled=False, device=None,
                 generator=None):
        super().__init__()
        check_single_rank(tp_size, sequence_parallel_enabled)
        device = default_device(device)
        self.skip_bias_add = skip_bias_add
        w = torch.empty(output_size, input_size, dtype=params_dtype,
                        device=device)
        self.weight = nn.Parameter(w.normal_(0.0, init_std,
                                             generator=generator))
        if bias:
            self.bias = nn.Parameter(torch.zeros(output_size,
                                                 dtype=params_dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        out = _mm(x, self.weight)
        if self.bias is not None and not self.skip_bias_add:
            out = out + self.bias.to(out.dtype)
        if self.skip_bias_add:
            return out, self.bias
        return out


class ColumnParallelLinear(_ParallelLinear):
    """``Y = X W^T + b``, ``W [out, in]``, partitioned along ``out`` at
    tp > 1 in the JAX package (whole here)."""


class RowParallelLinear(_ParallelLinear):
    """``Y = X W^T + b``, ``W [out, in]``, partitioned along ``in`` at
    tp > 1 in the JAX package (whole here)."""


def scaled_init_std(sigma, num_layers):
    """The output projections' init std, ``sigma / sqrt(2 num_layers)``."""
    return sigma / math.sqrt(2.0 * num_layers)
