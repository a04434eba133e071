"""Hidden dropout (counterpart of ``apex_tpu/utils.py`` and of
``bias_dropout_add`` / ``get_bias_dropout_add`` in
``apex_tpu/transformer/testing/standalone_transformer_lm.py:972-987``).

Elementwise work that XLA fuses on the TPU, so plain PyTorch here. Masks
come from an explicit ``torch.Generator`` on the tensor's device: the
same generator state gives the same mask, which is how a recomputed layer
(``recompute_granularity``) replays the masks of its first forward. The
draws are not JAX's (``jax.random.bernoulli`` over threefry keys), so the
tests hand both packages the same masks.
"""

import torch


def keep_mask(generator, shape, p, device):
    """Bool mask, True with probability ``1 - p``: a uniform fp32 draw
    below ``1 - p``, as ``jax.random.bernoulli(rng, 1 - p, shape)``
    compares."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u < 1.0 - p


def train_dropout(generator, x, p, zero=0.0):
    """Inverted dropout: keep with probability ``1 - p`` and rescale the
    survivors, ``where(keep, x / (1 - p), zero)``. The survivors are
    divided, not multiplied by a reciprocal, by ``1 - p`` rounded to x's
    dtype, as JAX divides an array by a Python float. The divisor is a
    tensor on x's device: on the card PyTorch turns a division by a host
    scalar into a multiplication by its reciprocal."""
    keep = keep_mask(generator, x.shape, p, x.device)
    keep_prob = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, zero)


def bias_dropout_add(x, bias, residual, prob, training, generator=None):
    """``residual + dropout(x + bias)``; dropout only when ``training``
    and ``prob > 0``, which needs a generator."""
    out = x + bias
    if training and prob > 0.0:
        if generator is None:
            raise ValueError("bias_dropout_add: a generator is required in "
                             "training")
        out = train_dropout(generator, out, prob)
    return residual + out


def get_bias_dropout_add(training):
    """:func:`bias_dropout_add` with ``training`` bound."""
    def _bias_dropout_add(x, bias, residual, prob, generator=None):
        return bias_dropout_add(x, bias, residual, prob, training, generator)
    return _bias_dropout_add
