"""Continuous-batching scheduler (host side; counterpart of
``apex_tpu/serving/scheduler.py``).

Runs BETWEEN decode steps: admit queued requests into free decode slots
(allocating their cache pages up front, all or nothing, so a mid-stream
request never runs out of pages), evict completed ones (freeing pages),
and materialize the fixed-shape arrays the decode step consumes.

Admission blocks at the head of the line: if the selected request does
not fit (no free slot, or the free list cannot cover its
``prompt + max_new_tokens`` pages), nothing else is admitted over it —
the no-starvation property. The policy is ``fifo`` (queue head) or
``priority`` (highest ``priority + waiting_ticks / AGING_TICKS``, oldest
first on ties); a per-call unknown policy raises, the ``APEX_SERVE_SCHED``
environment preference warns once and falls back.

:func:`synthetic_trace` is the seeded request trace every serving
measurement replays; it draws the same stream and ``tr-`` id as the JAX
package for the same arguments.

Not ported yet (their slices add them): the prefix-cache lookup, KV-
pressure preemption with its swap hook, and the chaos sites.
"""

import dataclasses
import hashlib
import math
import random
from collections import deque
from typing import Any, List, Optional

from apex_tpu_torch import _env
from apex_tpu_torch.serving.kv_cache import pages_needed

ARRIVALS = ("poisson", "diurnal")
POLICIES = ("fifo", "priority")
# priority aging: one effective-priority level per this many waiting ticks
AGING_TICKS = 8.0


def resolve_policy(per_call=None):
    """The effective scheduler policy: per-call (raises on unknown) >
    ``APEX_SERVE_SCHED`` preference (warns once and is ignored on
    unknown) > built-in FIFO."""
    if per_call is not None:
        if per_call not in POLICIES:
            raise ValueError(
                f"unknown scheduler policy {per_call!r} "
                f"(vocabulary: {POLICIES})")
        return per_call
    return _env.env_choice("APEX_SERVE_SCHED", POLICIES) or "fifo"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0          # logical tick the request appears at
    priority: int = 0             # policy "priority": higher admits first
    # per-request sampling controls (None = greedy); the engine refuses a
    # non-greedy request while sampling is not ported
    sampling: Optional[Any] = None
    # tick the request entered the queue (the priority policy's aging
    # base); None falls back to ``arrival``
    queued_tick: Optional[float] = None
    # filled in by the engine/scheduler:
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    enqueue_wall: Optional[float] = None
    finish_wall: Optional[float] = None
    admitted_wall: Optional[float] = None
    first_token_wall: Optional[float] = None
    admitted_tick: Optional[int] = None
    finished_tick: Optional[int] = None

    def done(self):
        return len(self.out_tokens) >= self.max_new_tokens


@dataclasses.dataclass
class Slot:
    request: Request
    pages: List[int]
    pos: int = 0                  # context length held in the cache
    next_token: int = 0           # token the next decode step consumes


class ContinuousBatchingScheduler:
    def __init__(self, num_slots, max_pages_per_slot, page_size,
                 allocator, policy=None):
        self.num_slots = int(num_slots)
        self.max_pages = int(max_pages_per_slot)
        self.page_size = int(page_size)
        self.allocator = allocator
        self.policy = resolve_policy(policy)
        self.slots = [None] * self.num_slots
        self.queue = deque()
        self.completed = []

    # ------------------------------------------------------- bookkeeping

    def submit(self, request, tick=None):
        """Enqueue one request; an impossible one raises here, before
        anything is enqueued. ``tick`` stamps ``queued_tick``."""
        self.validate(request)
        if tick is not None and request.queued_tick is None:
            request.queued_tick = tick
        self.queue.append(request)

    def validate(self, request):
        """Raise on a request no admission can ever serve."""
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.rid}: max_new_tokens must be >= 1 "
                f"(prefill always samples the first token)")
        need = self._request_pages(request)
        if need > self.max_pages:
            raise ValueError(
                f"request {request.rid}: {need} pages exceed the "
                f"per-slot table ({self.max_pages}) — prompt + "
                f"max_new_tokens over max_seq")

    def active_indices(self):
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _request_pages(self, req):
        return pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.page_size)

    def queue_depth(self):
        return len(self.queue)

    def _select(self, tick):
        """The admission candidate: the queue head under ``fifo``; under
        ``priority`` the highest effective priority, oldest first on
        ties."""
        if self.policy == "fifo" or len(self.queue) == 1:
            return self.queue[0]
        best, best_key = None, None
        for pos, r in enumerate(self.queue):
            queued = r.queued_tick if r.queued_tick is not None \
                else r.arrival
            eff = r.priority + max(0.0, tick - queued) / AGING_TICKS
            key = (-eff, pos)
            if best_key is None or key < best_key:
                best, best_key = r, key
        return best

    def admit(self, tick, wall_time=None):
        """Admit every queued request that fits under the policy,
        stopping at the first selected one that does not. Returns the
        newly filled slot indices."""
        admitted = []
        while self.queue:
            req = self._select(tick)
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            pages = self.allocator.alloc(("req", req.rid),
                                         self._request_pages(req))
            if pages is None:
                break
            self.queue.remove(req)
            idx = free[0]
            self.slots[idx] = Slot(request=req, pages=pages)
            req.admitted_tick = tick
            if wall_time is not None:
                req.admitted_wall = wall_time
            admitted.append(idx)
        return admitted

    def evict_done(self, tick, wall_time=None):
        """Free slots and pages of completed requests; returns them.
        ``wall_time`` backstops ``finish_wall`` where the finishing
        dispatch did not stamp it."""
        done = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.done():
                self.allocator.free(("req", slot.request.rid))
                slot.request.finished_tick = tick
                if wall_time is not None \
                        and slot.request.finish_wall is None:
                    slot.request.finish_wall = wall_time
                self.completed.append(slot.request)
                done.append(slot.request)
                self.slots[i] = None
        return done

    # ------------------------------------------- fixed-shape array views

    def page_table_rows(self):
        """int ``[num_slots][max_pages]``; empty slots and the unallocated
        tail -> null page 0."""
        rows = [[0] * self.max_pages for _ in range(self.num_slots)]
        for i, slot in enumerate(self.slots):
            if slot is not None:
                for j, p in enumerate(slot.pages):
                    rows[i][j] = p
        return rows

    def decode_inputs(self):
        """(tokens, lengths) int lists for the decode step: length 0
        marks an inactive slot."""
        tokens = [0] * self.num_slots
        lengths = [0] * self.num_slots
        for i, slot in enumerate(self.slots):
            if slot is not None:
                tokens[i] = int(slot.next_token)
                lengths[i] = slot.pos + 1
        return tokens, lengths


def synthetic_trace(seed=0, n_requests=16, vocab=256, prompt_lo=4,
                    prompt_hi=24, new_lo=4, new_hi=32,
                    mean_interarrival=0.5, arrival="poisson",
                    diurnal_period=32.0, diurnal_depth=0.8,
                    system_prompt=None):
    """Deterministic request trace: ``(requests, trace_id)``. Arrival is
    in decode-step ticks; the id is a content hash of every request's
    (arrival, prompt, max_new).

    ``arrival`` is ``"poisson"`` (exponential inter-arrivals at rate
    ``1/mean_interarrival``) or ``"diurnal"`` (the rate swings
    sinusoidally around the base with period ``diurnal_period`` and
    relative amplitude ``diurnal_depth``, floored at 5% of base).
    ``system_prompt`` is prepended to every prompt.
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival process {arrival!r} "
                         f"(vocabulary: {ARRIVALS})")
    rng = random.Random(seed)
    t = 0.0
    reqs = []
    for rid in range(n_requests):
        if mean_interarrival > 0:
            rate = 1.0 / mean_interarrival
            if arrival == "diurnal":
                rate *= 1.0 + diurnal_depth * math.sin(
                    2.0 * math.pi * t / diurnal_period)
                rate = max(rate, 0.05 / mean_interarrival)
            t += rng.expovariate(rate)
        plen = rng.randint(prompt_lo, prompt_hi)
        prompt = [rng.randrange(vocab) for _ in range(plen)]
        if system_prompt:
            prompt = [int(t) for t in system_prompt] + prompt
        reqs.append(Request(
            rid=rid, prompt=prompt,
            max_new_tokens=rng.randint(new_lo, new_hi),
            arrival=round(t, 3)))
    h = hashlib.sha1(repr(
        [(r.arrival, tuple(r.prompt), r.max_new_tokens)
         for r in reqs]).encode()).hexdigest()[:10]
    return reqs, f"tr-{h}"


def offered_load(requests):
    """Offered load of a trace in requests per tick: request count over
    the arrival span (1-tick floor); 0.0 for an empty trace."""
    if not requests:
        return 0.0
    span = max(r.arrival for r in requests)
    return len(requests) / max(span, 1.0)
