"""Tensor-parallel layers (counterpart of
``apex_tpu/transformer/tensor_parallel/layers.py``).

Each module holds this rank's shard of its weight, in the JAX (and
Megatron) layout ``[out, in]``, so one parameter tree serves both
packages, and runs the collectives of :mod:`.mappings` over the tp group
of :mod:`..parallel_state` (identities at tp = 1, where the modules hold
the whole weight). Sequence parallelism raises.

* :func:`_sharded_init` — the master weight is drawn at full shape from
  the generator and this rank keeps its slice (``_sharded_init :49``), so
  one seed gives the same full model at any tp and the generator stays in
  step across ranks.
* :func:`_mm` — ``x @ w^T`` in x's dtype (the JAX package's amp compute
  dtype with no policy active), fp32 accumulation, rounded once.
* :func:`vocab_parallel_embed` — rows of this rank's vocabulary shard,
  ids outside it masked to 0, summed over the group (``:68-86``).
* :class:`VocabParallelEmbedding`, :class:`ColumnParallelLinear` (``W``
  split along ``out``; copy-to on the input, an optional gather of the
  output), :class:`RowParallelLinear` (``W`` split along ``in``; the
  partial products summed over the group, the bias added after the sum);
  ``skip_bias_add`` returns ``(Y, b)``; parameters fp32
  (``params_dtype``), cast to the input dtype per call.
"""

import math

import torch
from torch import nn

from apex_tpu_torch import default_device
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.utils import divide


def _mm(x, w):
    """``x @ w^T`` in x's dtype with fp32 accumulation, rounded to x's
    dtype (half-precision products accumulate in fp32 in cuBLAS and on
    the CPU alike; fp32 runs in full fp32 with TF32 off)."""
    return torch.matmul(x, w.to(x.dtype).t())


def _sharded_init(full_shape, shard_dim, init_std, dtype, device,
                  generator):
    """This rank's shard of a normal(0, ``init_std``) master weight of
    ``full_shape``, split along ``shard_dim`` over the tp group."""
    master = torch.empty(full_shape, dtype=dtype, device=device).normal_(
        0.0, init_std, generator=generator)
    world = parallel_state.get_tensor_model_parallel_world_size()
    if world == 1:
        return master
    chunk = divide(full_shape[shard_dim], world)
    rank = parallel_state.get_tensor_model_parallel_rank()
    return master.narrow(shard_dim, rank * chunk, chunk).clone()


def vocab_parallel_embed(weight, input_ids, group=None):
    """Rows of ``weight``, this rank's vocabulary shard, at the global
    ``input_ids``: ids outside the shard give zero rows, and the partial
    lookups are summed over the group (at tp = 1 a plain lookup), in the
    table's dtype."""
    if group is None:
        group = parallel_state.get_tensor_model_parallel_group()
    if group is None or torch.distributed.get_world_size(group) == 1:
        return weight[input_ids]
    per_partition = weight.shape[0]
    start = torch.distributed.get_rank(group) * per_partition
    in_range = (input_ids >= start) & (input_ids < start + per_partition)
    masked = torch.where(in_range, input_ids - start, 0)
    out = torch.where(in_range[..., None], weight[masked], 0.0)
    return mappings.reduce_from_tensor_model_parallel_region(out, group)


def check_sequence_parallel(sequence_parallel):
    if sequence_parallel:
        raise ValueError("sequence parallelism is not ported")


class VocabParallelEmbedding(nn.Module):
    """An embedding table split along the vocabulary over the tp group."""

    def __init__(self, num_embeddings, embedding_dim, init_std=0.02,
                 params_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_sharded_init(
            (num_embeddings, embedding_dim), 0, init_std, params_dtype,
            default_device(device), generator))

    def forward(self, input_ids):
        return vocab_parallel_embed(self.weight, input_ids)


class _ParallelLinear(nn.Module):
    def __init__(self, input_size, output_size, shard_dim, bias=True,
                 skip_bias_add=False, init_std=0.02,
                 params_dtype=torch.float32, sequence_parallel_enabled=False,
                 device=None, generator=None):
        super().__init__()
        check_sequence_parallel(sequence_parallel_enabled)
        device = default_device(device)
        self.skip_bias_add = skip_bias_add
        self.weight = nn.Parameter(_sharded_init(
            (output_size, input_size), shard_dim, init_std, params_dtype,
            device, generator))
        if bias:
            # a column-parallel bias is split with the rows of W; a
            # row-parallel bias is whole on every rank
            n = self.weight.shape[0]
            self.bias = nn.Parameter(torch.zeros(n, dtype=params_dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def _add_bias(self, out):
        if self.bias is not None and not self.skip_bias_add:
            out = out + self.bias.to(out.dtype)
        return out

    def _result(self, out):
        return (out, self.bias) if self.skip_bias_add else out


class ColumnParallelLinear(_ParallelLinear):
    """``Y = X W^T + b``, ``W [out, in]`` split along ``out`` over the tp
    group; the input goes through copy-to (its gradient is summed over
    the group), and with ``gather_output`` the output shards are gathered
    along the last axis."""

    def __init__(self, input_size, output_size, bias=True,
                 gather_output=True, **kw):
        super().__init__(input_size, output_size, 0, bias, **kw)
        self.gather_output = gather_output

    def forward(self, x):
        x = mappings.copy_to_tensor_model_parallel_region(x)
        out = self._add_bias(_mm(x, self.weight))
        if self.gather_output:
            out = mappings.gather_from_tensor_model_parallel_region(out)
        return self._result(out)


class RowParallelLinear(_ParallelLinear):
    """``Y = X W^T + b``, ``W [out, in]`` split along ``in`` over the tp
    group; the input is this rank's slice of the last axis when
    ``input_is_parallel`` (else it is scattered), the partial products are
    summed over the group, and the bias is added after the sum."""

    def __init__(self, input_size, output_size, bias=True,
                 input_is_parallel=False, **kw):
        super().__init__(input_size, output_size, 1, bias, **kw)
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        if not self.input_is_parallel:
            x = mappings.scatter_to_tensor_model_parallel_region(x)
        out = mappings.reduce_from_tensor_model_parallel_region(
            _mm(x, self.weight))
        return self._result(self._add_bias(out))


def scaled_init_std(sigma, num_layers):
    """The output projections' init std, ``sigma / sqrt(2 num_layers)``."""
    return sigma / math.sqrt(2.0 * num_layers)
