"""Vocab-parallel cross entropy (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

:func:`vocab_parallel_cross_entropy` is a ``torch.autograd.Function``
over logits split along the vocabulary across the tp group of
:mod:`..parallel_state` (at tp = 1, the whole vocabulary and no
collectives), with the JAX package's residuals and closed-form backward
(``_ce_bwd :88``). The forward all-reduces the row max (MAX), the
range-masked target logit and the sum of exponentials (SUM), and with
label smoothing the sum of log-probabilities (SUM) for Megatron's
smoothing over the global vocabulary (``:59-66``); it keeps the input
logits, the fp32 global row max and sum of exponentials and the shard's
targets. The backward recomputes the softmax, subtracts this shard's
part of the one-hot target (with the smoothing adjustment), scales by the
incoming gradient and returns the logits' dtype; it is local to the rank.

The fp32 ``[tokens, vocab]`` temporaries are materialized one at a time
(XLA fuses them in the JAX package); the backward works in place on its
own temporary.
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import all_reduce_


def _rank_world(group):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _ce_forward(logits, target, label_smoothing, group):
    rank, world = _rank_world(group)
    part = logits.shape[-1]
    logits_max = all_reduce_(logits.amax(dim=-1).float(), group,
                             dist.ReduceOp.MAX)
    shifted = logits.float() - logits_max[..., None]
    start = rank * part
    in_range = (target >= start) & (target < start + part)
    local = torch.where(in_range, target - start, 0)
    predicted = torch.where(
        in_range, torch.gather(shifted, -1, local[..., None])[..., 0], 0.0)
    predicted = all_reduce_(predicted, group)
    sum_exp = all_reduce_(torch.exp(shifted).sum(dim=-1), group)
    loss = torch.log(sum_exp) - predicted
    if label_smoothing > 0:
        vocab = part * world
        smoothing = label_smoothing * vocab / (vocab - 1)
        log_probs = shifted - torch.log(sum_exp)[..., None]
        mean_log_probs = all_reduce_(log_probs.sum(dim=-1), group) / vocab
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
    return loss, logits_max, sum_exp, local, in_range


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, label_smoothing, group):
        loss, logits_max, sum_exp, local, in_range = _ce_forward(
            logits, target, label_smoothing, group)
        ctx.save_for_backward(logits, logits_max, sum_exp, local, in_range)
        ctx.label_smoothing = label_smoothing
        ctx.world = _rank_world(group)[1]
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, logits_max, sum_exp, local, in_range = ctx.saved_tensors
        grad = (logits.float() - logits_max[..., None]).exp_()
        grad.div_(sum_exp[..., None])                    # the softmax
        vocab = logits.shape[-1] * ctx.world
        hit = 1.0
        if ctx.label_smoothing > 0:
            smoothing = ctx.label_smoothing * vocab / (vocab - 1)
            hit = 1.0 - smoothing
        grad.scatter_add_(-1, local[..., None], torch.where(
            in_range, -hit, 0.0)[..., None])
        if ctx.label_smoothing > 0:
            grad.sub_(smoothing / vocab)
        grad.mul_(g[..., None])
        return grad.to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, target, label_smoothing=0.0,
                                 group=None):
    """Per-token fp32 cross-entropy loss of this rank's vocabulary shard
    of ``logits [..., vocab / tp]`` against the global integer ``target
    [...]``, over the tp group (default: :mod:`..parallel_state`'s)."""
    if group is None:
        group = parallel_state.get_tensor_model_parallel_group()
    return _VocabParallelCrossEntropy.apply(logits, target.long(),
                                            float(label_smoothing), group)
