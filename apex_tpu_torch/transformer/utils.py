"""Shared transformer utilities (counterpart of
``apex_tpu/transformer/utils.py``, which ``tensor_parallel/utils.py``
re-exports): the divisibility checks, the last-dimension split and the
vocabulary ranges of vocab-parallel layers."""

import torch


def ensure_divisibility(numerator, denominator):
    if numerator % denominator:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator, denominator):
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions):
    """``num_partitions`` equal views of ``tensor`` along its last axis."""
    size = divide(tensor.shape[-1], num_partitions)
    return list(torch.split(tensor, size, dim=-1)) if size else []


class VocabUtility:
    """The ``[first, last)`` vocabulary range of one rank's shard."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(per_partition_vocab_size,
                                                  rank, world_size):
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size, rank,
                                           world_size):
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            divide(global_vocab_size, world_size), rank, world_size)
