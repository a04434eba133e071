"""The tensor-parallel autograd mappings on ``torch.distributed``
(counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``):

  forward              | backward
  ---------------------|--------------------
  copy (identity)      | all-reduce           :func:`copy_to_tensor_model_parallel_region`
  all-reduce           | identity             :func:`reduce_from_tensor_model_parallel_region`
  split the last axis  | all-gather it        :func:`scatter_to_tensor_model_parallel_region`
  all-gather last axis | split it             :func:`gather_from_tensor_model_parallel_region`

Each takes the tp group (default: :mod:`..parallel_state`'s) and is the
identity where the group has one rank. A sum is taken in the tensor's own
dtype, as the JAX package's ``psum`` sums in the compute dtype; at two
ranks that is the exact sum rounded once. The sequence-parallel mappings
are not ported.

The all-reduce forward of :func:`reduce_from_tensor_model_parallel_region`
sums its input in place, as Megatron's does (a leaf that requires grad is
copied first); the all-reduce backward of
:func:`copy_to_tensor_model_parallel_region` sums a copy of the incoming
gradient, which autograd may also have handed to another input.
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state


def _group(group):
    return (parallel_state.get_tensor_model_parallel_group()
            if group is None else group)


def _world(group):
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x, group=None, op=dist.ReduceOp.SUM):
    """``x`` (contiguous) reduced over the tp group in place, and
    returned; left as it is where the group has one rank."""
    group = _group(group)
    if _world(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def _copy(x):
    return x.clone(memory_format=torch.contiguous_format)


def _split_along_last_dim(x, group):
    world = _world(group)
    if world == 1:
        return x
    if x.shape[-1] % world:
        raise ValueError(f"last dim {x.shape[-1]} is not divisible by the "
                         f"tensor-parallel size {world}")
    chunk = x.shape[-1] // world
    rank = dist.get_rank(group)
    return x[..., rank * chunk:(rank + 1) * chunk].contiguous()


def _gather_along_last_dim(x, group):
    world = _world(group)
    if world == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_copy(g), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        if x.is_leaf and x.requires_grad or not x.is_contiguous():
            return all_reduce_(_copy(x), group)
        ctx.mark_dirty(x)
        return all_reduce_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_along_last_dim(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_along_last_dim(g, ctx.group), None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_along_last_dim(x, group)

    @staticmethod
    def backward(ctx, g):
        return _split_along_last_dim(g, ctx.group), None


def copy_to_tensor_model_parallel_region(x, group=None):
    """Identity forward, all-reduce backward."""
    group = _group(group)
    return x if _world(group) == 1 else _CopyToRegion.apply(x, group)


def reduce_from_tensor_model_parallel_region(x, group=None):
    """All-reduce forward (of ``x`` in place), identity backward."""
    group = _group(group)
    return x if _world(group) == 1 else _ReduceFromRegion.apply(x, group)


def scatter_to_tensor_model_parallel_region(x, group=None):
    """This rank's chunk of the last axis forward, all-gather backward."""
    group = _group(group)
    return x if _world(group) == 1 else _ScatterToRegion.apply(x, group)


def gather_from_tensor_model_parallel_region(x, group=None):
    """All-gather along the last axis forward, this rank's chunk
    backward."""
    group = _group(group)
    return x if _world(group) == 1 else _GatherFromRegion.apply(x, group)
