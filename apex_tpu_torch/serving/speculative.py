"""Self-drafting speculative decode: the draft and accept arithmetic
(counterpart of ``apex_tpu/serving/speculative.py``; host side,
stdlib only).

The draft needs no second model: the most recent earlier occurrence of
the sequence's trailing n-gram proposes the tokens that followed it. A
verify round feeds the slot's full sequence (prompt + generated + draft)
as one segment of the engine's packed prefill call
(:func:`~apex_tpu_torch.serving.model.prefill`, K1 on the card): the
already-cached context positions write the all-null spare page-table
row, so the cache keeps its decode-written K/V, and only the pending
token and the draft write real pages. Acceptance takes the longest
draft prefix that matches the verify logits' greedy chain plus one bonus
token; rollback is length arithmetic (rejected positions stay in the
pages past the new length, never read, and are overwritten as the
sequence advances).

Knob: the engine's ``spec_decode=K`` is a demand (K < 1 or a non-int
raises here; a verify window deeper than the prefill bucket raises in
the engine); ``APEX_SPEC_DECODE`` is a preference (0 or unset is off,
garbage warns once and is ignored). Default off.
"""

from apex_tpu_torch import _env

NGRAM = 2  # trailing n-gram the draft matches


def resolve_k(per_call=None):
    """The effective draft length K: per-call (raises when it is not an
    int >= 1) > ``APEX_SPEC_DECODE`` preference (0/unset = off) > 0."""
    if per_call is not None:
        if isinstance(per_call, bool) or not isinstance(per_call, int) \
                or per_call < 1:
            raise ValueError(
                f"spec_decode= wants a draft length >= 1 or None, "
                f"got {per_call!r}")
        return per_call
    return _env.env_nonneg_int("APEX_SPEC_DECODE") or 0


def propose(history, k, ngram=NGRAM):
    """Up to ``k`` draft tokens for a sequence ending in ``history``
    (oldest first): the tokens that followed an earlier occurrence of the
    trailing ``ngram``, preferring the most recent occurrence with a full
    ``k``-token continuation, else the longest continuation found. An
    empty list when there is no earlier occurrence."""
    n = len(history)
    if k < 1 or n < ngram + 1:
        return []
    tail = list(history[-ngram:])
    best = []
    for i in range(n - ngram - 1, -1, -1):
        if list(history[i:i + ngram]) == tail:
            cont = list(history[i + ngram:i + ngram + k])
            if len(cont) == k:
                return cont
            if len(cont) > len(best):
                best = cont
    return best


def accept(draft, greedy):
    """The tokens one verified slot produces: ``draft`` is d_1..d_k,
    ``greedy`` the verify logits' argmax chain g_0..g_k (g_j follows
    position j of the verify window). The longest draft prefix matching
    the chain plus the bonus token: 1 to ``len(draft) + 1`` tokens, the
    stream plain greedy decode emits one token at a time."""
    out = []
    a = 0
    while a < len(draft) and draft[a] == greedy[a]:
        out.append(draft[a])
        a += 1
    out.append(greedy[a])
    return out


class SpecStats:
    """Per-engine speculation counters (``generation_stats``'s
    acceptance rate and mean draft length)."""

    def __init__(self):
        self.rounds = 0          # verified slots (one per verify lane)
        self.drafted = 0         # draft tokens proposed
        self.accepted = 0        # draft tokens accepted
        self.bonus = 0           # bonus tokens (1 per verified slot)

    def record(self, drafted, accepted):
        self.rounds += 1
        self.drafted += int(drafted)
        self.accepted += int(accepted)
        self.bonus += 1

    def acceptance_rate(self):
        """Accepted fraction of drafted tokens (None before any draft)."""
        if not self.drafted:
            return None
        return self.accepted / self.drafted

    def mean_draft_len(self):
        if not self.rounds:
            return None
        return self.drafted / self.rounds
