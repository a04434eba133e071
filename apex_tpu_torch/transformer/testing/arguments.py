"""Megatron's argument helpers (counterpart of
``apex_tpu/transformer/testing/arguments.py``); only the vocabulary
padding is ported."""


def pad_vocab_size(orig_vocab_size, tensor_model_parallel_size=1,
                   make_vocab_size_divisible_by=128):
    """The vocabulary padded up to a multiple of
    ``make_vocab_size_divisible_by * tensor_model_parallel_size``, so that
    every tp shard has a whole number of 128-row tiles (``:391-397``):
    GPT-2's 50257 gives 50304 at tp = 1 and 50432 at tp = 2."""
    mult = make_vocab_size_divisible_by * tensor_model_parallel_size
    return -(-orig_vocab_size // mult) * mult
