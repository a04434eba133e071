"""The amp-O2 training step (counterpart of ``bench.py:209
make_one_step``): compute-dtype forward and backward of a
:class:`~apex_tpu_torch.transformer.testing.GPTModel` or a
:class:`~apex_tpu_torch.transformer.testing.BertModel`, dynamic loss
scaling, a fused optimizer, and the skip-step selects of
``bench.py:240-245``.

    step = make_one_step(model, LossScaler(), fused_adam(1e-4))

The optimizer is a transform of :mod:`apex_tpu_torch.optimizers`. Where
it has an in-place fused form (``opt.step``: Adam and LAMB), the step
calls it with the overflow flag, and on the card the update and the skip
are one multi-tensor kernel (K14; K13 + K15 for LAMB) after the
unscale's K12; the others take ``opt.update`` and the per-leaf selects
(``optimizers/_base.apply_plain``), which are also the fused form's plain
version. The learning rate may be a schedule of the device step count,
computed on the device.
    opt_state, scaler_state, loss = step(opt_state, scaler_state,
                                         ids, pos, labels)

A BertModel's batch is ``(ids, attention_mask, labels)`` in the place of
``(ids, pos, labels)``: the loss is the mean of its per-token MLM loss,
as ``examples/transformer/pretrain.py:151-162`` computes it for ``--model
bert``. A parameter outside the loss (BERT's pooler and binary head, and
the tokentype table when no tokentype ids are given) gets a zero
gradient, as ``jax.grad`` gives it, so that the optimizer updates it as
the JAX step does (LAMB's weight decay moves it).

With ``dropout_generator`` (a ``torch.Generator`` on the model's device)
the step trains with the configuration's hidden and attention dropout,
the counterpart of ``benchmarks/profile_gpt.py:181-207
make_train_step(model, rng_of)``: each step draws its masks and seeds
from the generator where the JAX step folds the step index into its key.

At tensor-parallel size above 1 (a ``GPTModel(cfg, tp_size=tp)`` in each
rank of the group) the scaler is a
:class:`apex_tpu_torch.transformer.amp.GradScaler`, whose overflow flag is
the MAX over the group, so that every rank skips the same steps. Without
sequence parallelism the replicated parameters (layer norms, the position
table, row-parallel biases) get the same gradient on every rank, and each
rank's Adam keeps them equal.

The step never waits on the host: the overflow decision is a device bool
and the skip is ``torch.where``, so nothing calls ``.item()`` or
``bool()`` on a device tensor and a caller can queue steps back to back.

The JAX step is a pure function of (params, state); this one updates in
place to save memory: the model's parameters and the optimizer state's
tensors are overwritten (left as they were where the step is skipped),
and the returned ``opt_state`` is the same object. Gradients are dropped
(``grad = None``) at the start of a step.
"""

import torch

from apex_tpu_torch.optimizers._base import apply_plain
from apex_tpu_torch.transformer.amp import GradScaler


def per_token_loss(out):
    """The per-token loss of a model's output given labels: the output
    itself, or the first element of a tuple (a BertModel's ``(lm_loss,
    binary_logits)``)."""
    return out[0] if isinstance(out, tuple) else out


def make_one_step(model, scaler, opt, dropout_generator=None):
    """``one_step(opt_state, scaler_state, ids, pos, labels) ->
    (opt_state, scaler_state, loss)`` (``pos`` is the attention mask for
    a BertModel); ``loss`` is the unscaled mean per-token loss, a 0-d fp32
    device tensor. With ``dropout_generator`` the model runs with
    ``deterministic=False``; without it the step is deterministic."""
    if getattr(model, "tp_size", 1) > 1 and not isinstance(scaler,
                                                          GradScaler):
        raise ValueError("make_one_step: at tensor-parallel size "
                         f"{model.tp_size} the scaler must be a "
                         "transformer.amp.GradScaler (its overflow flag is "
                         "shared by the ranks)")
    params = dict(model.named_parameters())
    drop = {}
    if dropout_generator is not None:
        drop = dict(deterministic=False, dropout_generator=dropout_generator)

    def one_step(opt_state, scaler_state, ids, pos, labels):
        for p in params.values():
            p.grad = None
        per_tok = per_token_loss(model(ids, pos, None, labels, **drop))
        loss = torch.mean(per_tok) * scaler_state.loss_scale
        loss.backward()
        with torch.no_grad():
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in params.items()}
            grads, found_inf = scaler.unscale(grads, scaler_state)
            new_scaler_state = scaler.update(scaler_state, found_inf)
            fused = getattr(opt, "step", None)
            if fused is not None:
                fused(grads, opt_state, params, found_inf)
            else:
                apply_plain(opt.update, grads, opt_state, params, found_inf)
        for p in params.values():
            p.grad = None
        return (opt_state, new_scaler_state,
                loss.detach() / scaler_state.loss_scale)

    return one_step
