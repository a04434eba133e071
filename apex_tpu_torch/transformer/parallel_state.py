"""Tensor-parallel process groups on ``torch.distributed`` (counterpart of
``apex_tpu/transformer/parallel_state.py``, which lays the ranks out as a
``(pp, dp, tp)`` mesh).

Only the tensor-parallel group is modelled: pipeline size 1, and the
data-parallel size is ``world / tp``. The tp groups are blocks of
consecutive ranks (tp fastest, as the JAX mesh and Megatron order them):
ranks ``[k tp, (k + 1) tp)`` form group k.

The caller starts ``torch.distributed`` itself
(``init_process_group(backend, init_method=..., world_size=...,
rank=...)``; nothing here reads a cluster from the environment) and then
calls :func:`initialize_model_parallel` with the backend of the tp
groups, ``"nccl"`` (one card a rank) or ``"gloo"`` (which also runs the
all-reduces the tp > 1 path needs on CUDA tensors, through the host, so
that ranks may share a card). Nothing picks a backend quietly.

Where one tp group spans the whole world on the default group's backend,
that default group is the tp group (no second communicator is built).

Until a group is initialized the tensor-parallel world size is 1 and the
rank 0, so every tp = 1 path runs without ``torch.distributed``.
"""

import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# the one tp group of this process, its size and this process's rank in it
_TP_GROUP = None
_TP_SIZE = 1
_TP_RANK = 0
_TP_SRC_RANK = 0
_TP_GROUP_OWNED = False     # built here (destroyed here), not the default


def initialize_model_parallel(tensor_model_parallel_size=1, backend=None):
    """Build the tensor-parallel groups (every rank calls this, as
    ``new_group`` is collective). ``backend`` names the groups' backend,
    ``"nccl"`` or ``"gloo"``; it is required for a size above 1.
    Returns this process's tp group (None at size 1)."""
    global _TP_GROUP, _TP_SIZE, _TP_RANK, _TP_SRC_RANK, _TP_GROUP_OWNED
    tp = int(tensor_model_parallel_size)
    if tp < 1:
        raise ValueError(f"tensor_model_parallel_size {tp} < 1")
    if tp == 1:
        destroy_model_parallel()
        return None
    if backend not in BACKENDS:
        raise ValueError(f"initialize_model_parallel: backend must be one "
                         f"of {BACKENDS} at tensor-parallel size {tp}, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("initialize_model_parallel: start "
                           "torch.distributed first (init_process_group "
                           "with an address, the world size and the rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f"world size {world} is not divisible by the "
                         f"tensor-parallel size {tp}")
    destroy_model_parallel()
    if tp == world and dist.get_backend() == backend:
        _TP_GROUP, _TP_GROUP_OWNED = dist.group.WORLD, False
    else:
        for k in range(world // tp):
            ranks = list(range(k * tp, (k + 1) * tp))
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                _TP_GROUP, _TP_SRC_RANK = group, ranks[0]
        _TP_GROUP_OWNED = True
    _TP_SIZE, _TP_RANK = tp, rank % tp
    return _TP_GROUP


def model_parallel_is_initialized():
    return _TP_GROUP is not None


def destroy_model_parallel():
    """Drop the tp group (the default process group stays the caller's)."""
    global _TP_GROUP, _TP_SIZE, _TP_RANK, _TP_SRC_RANK, _TP_GROUP_OWNED
    if _TP_GROUP_OWNED and dist.is_initialized():
        dist.destroy_process_group(_TP_GROUP)
    _TP_GROUP, _TP_SIZE, _TP_RANK, _TP_SRC_RANK = None, 1, 0, 0
    _TP_GROUP_OWNED = False


def get_tensor_model_parallel_group():
    """This process's tp group, or None when none is initialized."""
    return _TP_GROUP


def get_tensor_model_parallel_world_size():
    return _TP_SIZE


def get_tensor_model_parallel_rank():
    return _TP_RANK


def get_tensor_model_parallel_src_rank():
    """The global rank of the first member of this process's tp group."""
    return _TP_SRC_RANK
