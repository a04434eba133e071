"""Vocab-parallel cross entropy at tp=1 (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

:func:`vocab_parallel_cross_entropy` is a ``torch.autograd.Function``
with the JAX package's residuals and closed-form backward (``_ce_bwd
:88``): the forward keeps the input logits, the fp32 row max and sum of
exponentials and the target; the backward recomputes the softmax,
subtracts the one-hot target (with the label-smoothing adjustment of
``:59-66``), scales by the incoming gradient and returns the logits'
dtype. At tp=1 every target lies in the one vocab shard, so the range
mask of the JAX code is all-true and the cross-rank sums are identities.

The fp32 ``[tokens, vocab]`` temporaries are materialized one at a time
(XLA fuses them in the JAX package); the backward works in place on its
own temporary.
"""

import torch


def _ce_forward(logits, target, label_smoothing):
    logits_max = logits.amax(dim=-1).float()
    shifted = logits.float() - logits_max[..., None]
    predicted = torch.gather(shifted, -1, target[..., None])[..., 0]
    sum_exp = torch.exp(shifted).sum(dim=-1)
    loss = torch.log(sum_exp) - predicted
    if label_smoothing > 0:
        vocab = logits.shape[-1]
        smoothing = label_smoothing * vocab / (vocab - 1)
        log_probs = shifted - torch.log(sum_exp)[..., None]
        mean_log_probs = log_probs.sum(dim=-1) / vocab
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
    return loss, logits_max, sum_exp


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        loss, logits_max, sum_exp = _ce_forward(logits, target,
                                                label_smoothing)
        ctx.save_for_backward(logits, logits_max, sum_exp, target)
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, logits_max, sum_exp, target = ctx.saved_tensors
        grad = (logits.float() - logits_max[..., None]).exp_()
        grad.div_(sum_exp[..., None])                    # the softmax
        vocab = logits.shape[-1]
        if ctx.label_smoothing > 0:
            smoothing = ctx.label_smoothing * vocab / (vocab - 1)
            grad.scatter_add_(-1, target[..., None], torch.full_like(
                grad[..., :1], -(1.0 - smoothing)))
            grad.sub_(smoothing / vocab)
        else:
            grad.scatter_add_(-1, target[..., None],
                              torch.full_like(grad[..., :1], -1.0))
        grad.mul_(g[..., None])
        return grad.to(logits.dtype), None, None


def vocab_parallel_cross_entropy(logits, target, label_smoothing=0.0):
    """Per-token fp32 cross-entropy loss of ``logits [..., vocab]``
    against integer ``target [...]``."""
    return _VocabParallelCrossEntropy.apply(logits, target.long(),
                                            float(label_smoothing))
