"""Batched stochastic sampling for the serving decode program
(counterpart of ``apex_tpu/serving/sampling.py``).

Temperature / top-k / top-p sampling as tensor operations inside the one
decode program: every per-request parameter (temperature, top_k, top_p,
the threefry key lane, the per-request sample counter) rides into
:func:`sample_tokens` as a ``[B]``-shaped tensor the engine re-stages each
round, so admitting, evicting or re-seeding requests changes tensor values
only, and a decode program captured once as a CUDA graph stays valid.

Determinism is per request, not per batch: each request carries its own
threefry key (:func:`request_key`, ``jax.random.PRNGKey(seed)``'s two
words) and every sampled token folds in the request's own generation index
(``fold_in(key, n_generated)``), so a seeded request's stream does not
depend on the batch, the slot or the block size around it.

The random bits are JAX's, bit for bit: :func:`threefry2x32` is the
20-round Threefry-2x32 hash of ``jax._src.prng`` on uint32 values held in
int64 tensors (PyTorch has no uint32 arithmetic on CUDA) and masked to 32
bits after every addition and shift; :func:`fold_in` hashes the pair ``(0,
data)`` under the key, and :func:`random_bits` is the counter layout JAX
0.9 uses with ``jax_threefry_partitionable`` on (the default): element
``i`` hashes the pair ``(0, i)`` and xors the two words. :func:`gumbel` is
``jax.random.gumbel``'s default ("low") mode: a uniform on ``[tiny, 1)``
from the top 23 bits as a mantissa, then ``-log(-log(u))``; the logarithm
is the only operation that may differ from XLA's, by an ulp.

Greedy exactness: a temperature-0 lane takes the exact
``argmax(logits.float())`` of the greedy decode step, not a limit of the
softmax path, so a sampling-enabled engine over all-greedy requests
reproduces the greedy engine token for token.

Knob: ``sampling=`` at engine build (a per-call non-bool raises; a
sampling-off engine raises at ``submit`` when a request demands
stochastic parameters) > :func:`set_sampling` > ``APEX_SERVE_SAMPLING``
env preference > off: with sampling in the program even all-greedy
batches pay for the sort and the top-p pass.
"""

import dataclasses

import numpy as np
import torch

from apex_tpu_torch import _env

_SAMPLING = None  # process-wide tri-state preference
_M32 = 0xFFFFFFFF
# Threefry-2x32's rotations, the two halves of its 20 rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = np.finfo(np.float32).tiny


def set_sampling(value):
    """Pin the process-wide sampling preference (True/False), or un-pin
    with None (env then default apply). A non-bool raises."""
    global _SAMPLING
    if value is not None and not isinstance(value, bool):
        raise ValueError(
            f"set_sampling wants True/False/None, got {value!r}")
    _SAMPLING = value


def resolve(per_call=None):
    """The effective sampling decision: per-call (a non-bool raises) >
    setter > ``APEX_SERVE_SAMPLING`` env ("1"/"0"; other values warn once
    and are ignored) > off."""
    if per_call is not None:
        if not isinstance(per_call, bool):
            raise ValueError(
                f"sampling= wants True/False/None, got {per_call!r}")
        return per_call
    if _SAMPLING is not None:
        return _SAMPLING
    v = _env.env_choice("APEX_SERVE_SAMPLING", ("1", "0"))
    if v is not None:
        return v == "1"
    return False


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls. ``temperature=0`` is exact greedy
    (the argmax path); ``top_k=0`` / ``top_p=1`` disable their
    truncations. ``seed`` keys the request's private threefry lane."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def validate(self):
        problems = []
        if self.temperature < 0:
            problems.append(f"temperature {self.temperature} < 0")
        if self.top_k < 0:
            problems.append(f"top_k {self.top_k} < 0")
        if not 0.0 < self.top_p <= 1.0:
            problems.append(f"top_p {self.top_p} not in (0, 1]")
        if problems:
            raise ValueError("invalid SamplingParams: "
                             + "; ".join(problems))

    @property
    def greedy(self):
        return self.temperature == 0.0


GREEDY = SamplingParams()


def request_key(seed):
    """The request's threefry key lane, ``uint32[2]``: what
    ``jax.random.PRNGKey(seed)`` gives with 64-bit types off (JAX's
    default), the seed's low 32 bits behind a zero word."""
    return np.array([0, int(seed) & _M32], np.uint32)


# ------------------------------------------------------ threefry (JAX's)

def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the count pairs ``(x1, x2)`` under the
    key ``(k1, k2)``; int64 tensors (or ints) holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x2 ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(keys, data):
    """``jax.random.fold_in`` per lane: ``keys`` ``[B, 2]`` and ``data``
    ``[B]`` integer tensors; returns the new key words ``(k1, k2)``, each
    ``[B]`` int64."""
    keys = keys.long() & _M32
    return threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(keys[:, 0]),
                        data.long() & _M32)


def random_bits(k1, k2, n):
    """``[B, n]`` 32-bit random words (int64) under the lanes' keys, in
    JAX's partitionable counter layout: element i hashes ``(0, i)`` and
    xors the two output words."""
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(keys, counters, n):
    """``jax.random.gumbel(jax.random.fold_in(key, counter), (n,),
    float32)`` for every lane: ``[B, n]`` fp32."""
    bits = random_bits(*fold_in(keys, counters), n)
    # the top 23 bits as the mantissa of a float in [1, 2), minus 1
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    # JAX's scale and shift onto [tiny, 1): (1 - tiny) is 1 in fp32
    span = np.float32(1.0) - np.float32(_TINY)
    u = torch.clamp_min(floats * float(span) + float(_TINY), float(_TINY))
    return -torch.log(-torch.log(u))


# ------------------------------------------------------------- lanes

def _lane_buffers(n):
    """Zeroed/off-valued lane arrays for ``n`` lanes: ``(temps, top_ks,
    top_ps, keys, counters)``."""
    return (np.zeros((n,), np.float32), np.zeros((n,), np.int32),
            np.ones((n,), np.float32), np.zeros((n, 2), np.uint32),
            np.zeros((n,), np.int32))


def fill_lane(request, i, temps, top_ks, top_ps, keys):
    """Stage one request's sampling parameters and key into lane ``i``:
    the one fill both the decode staging and the first-token sampling go
    through. The key is derived once and cached on the request (a greedy
    lane never reads its key; the zero lane is fine)."""
    p = getattr(request, "sampling", None) or GREEDY
    temps[i] = p.temperature
    top_ks[i] = p.top_k
    top_ps[i] = p.top_p
    key = getattr(request, "rng_key", None)
    if key is None and p.temperature > 0:
        key = request_key(p.seed)
        request.rng_key = key
    if key is not None:
        keys[i] = key


def lane_arrays(slots, num_slots):
    """The per-round ``[B]`` lane arrays of the decode program, rebuilt
    from the live slots: ``(temps, top_ks, top_ps, keys, counters)``. The
    counter is the request's own generation index
    (``len(out_tokens)``)."""
    temps, top_ks, top_ps, keys, counters = _lane_buffers(int(num_slots))
    for i, slot in enumerate(slots):
        if slot is None:
            continue
        fill_lane(slot.request, i, temps, top_ks, top_ps, keys)
        counters[i] = len(slot.request.out_tokens)
    return temps, top_ks, top_ps, keys, counters


def batch_lanes(requests):
    """Lane arrays for an explicit request list (the first-token sampling
    over a packed prefill batch): counters stay 0, the first token is
    generation index 0."""
    temps, top_ks, top_ps, keys, counters = _lane_buffers(len(requests))
    for i, req in enumerate(requests):
        fill_lane(req, i, temps, top_ks, top_ps, keys)
    return temps, top_ks, top_ps, keys, counters


def sample_tokens(logits, temps, top_ks, top_ps, keys, counters, active):
    """One sampled token per lane from ``[B, V]`` logits, as tensor
    operations with no host read (so it can be captured in a CUDA graph).

    temps/top_ps ``[B]`` fp32, top_ks/counters ``[B]`` int, keys ``[B, 2]``
    integers holding the uint32 key words (int32 storage is read as its
    bits), active ``[B]`` bool. A lane with ``temps[i] == 0`` takes the
    exact fp32 argmax; otherwise the logits are divided by the
    temperature, truncated to the top-k set (0 = off) and to the top-p
    nucleus (1 = off; the crossing token is kept, so the set is never
    empty), and the token is drawn by Gumbel-max under ``fold_in(keys[i],
    counters[i])``. Inactive lanes give 0. Returns ``[B]`` int32.
    """
    lf = logits.float()
    V = lf.shape[-1]
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)

    scaled = lf / torch.clamp_min(temps.float(), 1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: the kth largest value is the keep threshold (k = 0 -> V)
    k_eff = torch.where(top_ks > 0, top_ks, V)
    k_idx = torch.clamp(k_eff - 1, 0, V - 1).long()
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    keep_k = scaled >= kth
    # top-p over the sorted probabilities (jax.nn.softmax's arithmetic): a
    # sorted position is kept while the mass before it is under p; the
    # smallest kept sorted value is the unsorted keep threshold
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = before < top_ps.float()[:, None]
    cut_idx = torch.clamp_min(keep_sorted.sum(dim=-1) - 1, 0)
    cut = torch.gather(sorted_desc, 1, cut_idx[:, None])
    keep_p = scaled >= cut
    masked = torch.where(keep_k & keep_p, scaled,
                         torch.full_like(scaled, float("-inf")))

    drawn = torch.argmax(masked + gumbel(keys, counters, V),
                         dim=-1).to(torch.int32)
    toks = torch.where(temps <= 0.0, greedy, drawn)
    return torch.where(active, toks, torch.zeros_like(toks))
