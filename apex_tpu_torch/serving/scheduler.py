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

With a :class:`~apex_tpu_torch.serving.prefix_cache.PrefixCache`,
admission looks the prompt up first: shared full pages enter the slot's
table by reference (refcounted; only the remainder allocates), a matched
partial tail page schedules a copy-on-write into the slot's first
private page (``Slot.cow_copies``; the engine copies), and a short free
list asks the cache to reclaim unreferenced pages before blocking.

With ``preempt=True`` (KV-pressure preemption) admission reserves the
known stream's pages only, :meth:`ContinuousBatchingScheduler.grow`
extends a table mid-stream, and a refused grant preempts the running
request of lowest priority (:meth:`~ContinuousBatchingScheduler.
requeue_slot`: pages freed, prefix references released, the known stream
kept in ``resume_tokens`` for re-admission, the engine's ``swap_out``
callback offered the pages first). Round recovery and the fleet router's
failover drain requeue slots the same way, without the swap.

The ``serve_alloc`` chaos site (:mod:`apex_tpu_torch.resilience.faults`,
tests only) can refuse a page grant at a chosen (tick, phase) without
shrinking the pool, so the preemption path runs under scripted pressure.
"""

import dataclasses
import hashlib
import math
import random
from collections import deque
from typing import Any, List, Optional, Tuple

from apex_tpu_torch import _env
from apex_tpu_torch.resilience import faults as _faults
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
    # per-request sampling controls (serving.sampling.SamplingParams; None
    # = greedy); an engine built without sampling refuses a stochastic one
    sampling: Optional[Any] = None
    # the request's threefry key lane (uint32[2]), derived and cached when
    # its sampling lane is first staged (serving.sampling.fill_lane)
    rng_key: Optional[Any] = None
    # tick the request entered the queue (the priority policy's aging
    # base); None falls back to ``arrival``
    queued_tick: Optional[float] = None
    # KV-pressure preemption: the request's known stream (prompt +
    # generated tokens) when it was preempted past its first token, which
    # re-admission replays or restores; None otherwise
    resume_tokens: Optional[List[int]] = None
    preemptions: int = 0
    # the host swap tier's handle of a preempted stream's pages
    # (kv_tier.SwappedPages), banked by the engine's swap_out callback
    swapped: Optional[Any] = None
    shed_tick: Optional[int] = None   # where the deadline shedder dropped it
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
    # the known stream the slot consumes before generating: the prompt,
    # or a resumed request's prompt + generated tokens; the decode loop's
    # warm-up bookkeeping keys on its length
    known: List[int] = dataclasses.field(default_factory=list)
    # prefix-cache bookkeeping (empty when the cache is off or missed):
    # the shared full pages, the prompt tokens the cache covered, and the
    # (src, dst) page copies the engine makes before the first write
    shared_pages: List[int] = dataclasses.field(default_factory=list)
    prefix_hit: int = 0
    cow_copies: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


class ContinuousBatchingScheduler:
    def __init__(self, num_slots, max_pages_per_slot, page_size,
                 allocator, policy=None, prefix=None, preempt=False,
                 swap_out=None):
        self.num_slots = int(num_slots)
        self.max_pages = int(max_pages_per_slot)
        self.page_size = int(page_size)
        self.allocator = allocator
        self.policy = resolve_policy(policy)
        self.prefix = prefix      # PrefixCache or None (engine-owned)
        self.preempt = bool(preempt)
        # ``swap_out(slot) -> handle or None`` banks a victim's pages
        # before they are freed (the engine's host swap tier); None: off
        self.swap_out = swap_out
        self.slots = [None] * self.num_slots
        self.queue = deque()
        self.completed = []
        self.shed = []            # deadline-shed requests (engine-fed)
        self._preempted = []      # preempted since the last drain

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

    def head_of_line_wait(self, wall_time, tick=None):
        """Seconds the blocking request (:meth:`_select`'s pick) has
        waited at ``wall_time``; 0.0 with an empty queue or an unstamped
        head."""
        if not self.queue:
            return 0.0
        head = self._select(tick if tick is not None else 0)
        if head.enqueue_wall is None:
            return 0.0
        return max(0.0, wall_time - head.enqueue_wall)

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

    def _alloc_with_reclaim(self, owner, n, protect=(), tick=None,
                            phase="admit"):
        """An allocator grant that, when the free list is short, asks
        the prefix cache to reclaim unreferenced pages first (never the
        ``protect`` cover the admission in flight just matched) and
        retries once. The ``serve_alloc`` chaos site can refuse it at a
        (tick, phase)."""
        if _faults.denied("serve_alloc", tick=tick, phase=phase):
            return None
        pages = self.allocator.alloc(owner, n)
        if pages is None and self.prefix is not None:
            shortfall = n - self.allocator.free_count
            if self.prefix.reclaim(shortfall,
                                   protect=protect) >= shortfall:
                pages = self.allocator.alloc(owner, n)
        return pages

    def admit(self, tick, wall_time=None):
        """Admit every queued request that fits under the policy,
        stopping at the first selected one that does not. Returns the
        newly filled slot indices. A prompt's cached cover enters the
        slot by reference (full pages) and copy-on-write (the tail), and
        only the remainder allocates; under preemption only the known
        stream's pages are reserved."""
        admitted = []
        while self.queue:
            req = self._select(tick)
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            known = req.resume_tokens or req.prompt
            shared, covered, tail = [], 0, None
            # a resumed request skips the lookup: its known stream is
            # not what the chains are keyed by
            if self.prefix is not None and req.resume_tokens is None:
                shared, covered, tail = self.prefix.lookup(req.prompt)
            matched = list(shared) + ([tail[0]] if tail else [])
            reserve = pages_needed(len(known), self.page_size) \
                if self.preempt else self._request_pages(req)
            pages = self._alloc_with_reclaim(("req", req.rid),
                                             reserve - len(shared),
                                             protect=matched, tick=tick)
            if pages is None:
                break
            self.queue.remove(req)
            idx = free[0]
            slot = Slot(request=req, pages=shared + pages,
                        shared_pages=list(shared), prefix_hit=covered,
                        known=list(known))
            if covered:
                # the covered suffix runs through decode: position
                # ``covered`` is the first token fed
                slot.pos = covered
                slot.next_token = req.prompt[covered]
                if tail is not None:
                    # the snapshot lands in the slot's first private page
                    # before any write
                    slot.cow_copies.append((tail[0], pages[0]))
            if shared:
                self.prefix.acquire(shared)
            if self.prefix is not None:
                self.prefix.count(len(req.prompt), covered)
            self.slots[idx] = slot
            req.admitted_tick = tick
            if wall_time is not None:
                req.admitted_wall = wall_time
            admitted.append(idx)
        return admitted

    # ------------------------------------------ KV-pressure preemption

    def _select_victim(self, tick):
        """The slot to preempt under page pressure: the lowest base
        priority among running slots (running requests do not age), the
        latest admission first on ties, then the highest rid. A slot whose
        request already finished is never a victim. None when nothing is
        preemptible."""
        best, best_key = None, None
        for i, slot in enumerate(self.slots):
            if slot is None or slot.request.done():
                continue
            r = slot.request
            key = (r.priority,
                   -(r.admitted_tick if r.admitted_tick is not None
                     else tick),
                   -r.rid)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def requeue_slot(self, i, tick, swap=True):
        """Force running slot *i* back into the queue (preemption, round
        recovery, the failover drain): offer it to the ``swap_out``
        callback (with ``swap``; the engine passes False where the device
        cache is what it no longer trusts) before its pages are freed,
        free its private pages, release its shared prefix pages, keep its
        known stream in ``resume_tokens`` (None before its first token:
        re-admission is then a plain prefill) and requeue it (its
        ``queued_tick`` kept, so priority aging keeps its seniority).
        Returns the request."""
        slot = self.slots[i]
        req = slot.request
        req.swapped = (self.swap_out(slot)
                       if swap and self.swap_out is not None else None)
        self.allocator.free(("req", req.rid))
        if slot.shared_pages and self.prefix is not None:
            self.prefix.release(slot.shared_pages)
        req.resume_tokens = (list(req.prompt) + list(req.out_tokens)) \
            if req.out_tokens else None
        req.preemptions += 1
        self.slots[i] = None
        self.queue.append(req)
        return req

    def grow(self, i, min_pages, tick):
        """Make slot *i*'s table hold at least ``min_pages`` pages,
        preempting the victim :meth:`_select_victim` names each time a
        grant is refused (possibly *i* itself: then False). The engine's
        pool check (``num_pages - 1 >= max_pages``) guarantees a lone
        slot can always grow to ``max_seq``."""
        slot = self.slots[i]
        while len(slot.pages) < min_pages:
            got = self._alloc_with_reclaim(
                ("req", slot.request.rid), 1, tick=tick, phase="grow")
            if got is not None:
                slot.pages.extend(got)
                continue
            victim = self._select_victim(tick)
            if victim is None:
                return False
            self._preempted.append(self.requeue_slot(victim, tick))
            if victim == i:
                return False
        return True

    def take_preempted(self):
        """The requests preempted since the last call (the engine records
        their events and counters)."""
        out, self._preempted = self._preempted, []
        return out

    def evict_done(self, tick, wall_time=None):
        """Free slots and pages of completed requests; returns them.
        Shared prefix pages are released, not freed. ``wall_time``
        backstops ``finish_wall`` where the finishing dispatch did not
        stamp it."""
        done = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.done():
                self.allocator.free(("req", slot.request.rid))
                if slot.shared_pages and self.prefix is not None:
                    self.prefix.release(slot.shared_pages)
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
