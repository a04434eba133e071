"""ServingEngine: cache + parameters + scheduler in one object
(counterpart of ``apex_tpu/serving/engine.py``, the serial round).

All host work (admission, eviction, page accounting, input staging)
happens between device calls. One scheduler round (:meth:`step`): submit
due arrivals, evict finished requests, admit what fits, prefill the
admitted prompts in packed ``[prefill_len]`` batches (the prefill
attention kernel), then one decode program for every occupied slot (the
decode attention kernel). The cache and operand shapes are fixed at
construction; scheduler events change values only.

The decode program and its knobs (JAX's resolution rules: a per-call
argument is a demand and raises when it cannot be honored, an
environment value is a preference):

* ``sampling=`` (> :func:`sampling.set_sampling` > ``APEX_SERVE_SAMPLING``,
  default off): per-request temperature / top-k / top-p on private
  threefry lanes (:mod:`~apex_tpu_torch.serving.sampling`), JAX's random
  bits bit for bit; the lanes ride the program as ``[B]`` tensors
  restaged every round, and each request's first token is drawn from its
  prefill logits under the same lane. A stochastic request submitted to
  a sampling-off engine raises at :meth:`submit`.
* ``decode_k=`` (> ``APEX_SERVE_DECODE_K``, default 1): K decode steps in
  one program (:func:`model.decode_block`). A lane's warm-up steps (a
  prefix hit's covered suffix, a resumed stream's overflow past
  ``prefill_len``) consume known tokens and emit nothing; its budget is
  ``min(K, warm + remaining tokens)``. Admission and eviction happen at
  block boundaries; a lane that finishes mid-block rides the rest of the
  block masked (its writes go to null page 0, its tokens are discarded).
  On the card K > 1 buys nothing over the graph below, which already
  spreads the per-dispatch cost that the block exists to spread (graphed K = 4 measured 0.89-1.08x graphed K = 1's
  tokens/s on an H100, PERF.md); it is kept for parity with the JAX
  engine, and the default stays 1.
* ``cuda_graph=`` (None: graphed on the card, eager on the CPU; True on
  the CPU raises): on the card the decode program (``decode_step``, or
  ``decode_block`` at K > 1, with the sampler when sampling is on) is
  captured once at construction, after one warm-up call, as a
  ``torch.cuda.CUDAGraph``, and every round replays it. Its inputs are
  one static int32 buffer refreshed by a single host-to-device copy a
  round (eager rounds read the same buffer, so both modes compute from
  the same tensors); the cache keeps its storage (every write is in
  place, checked before each replay); a capture or replay that fails
  raises, with no fallback to eager. Prefill stays eager. The kernel
  wrappers count their own calls only: the warm-up and the capture call
  each once (the capture records the launch into the graph), and a
  replay calls no wrapper, so replayed kernels are seen only by a device
  trace (``chip_smoke.py`` counts them by name under torch.profiler).
  Each engine captures on a
  stream of its own (so its graph has decode attention's ticket array to
  itself), and PyTorch keeps a cuBLAS workspace for that stream for the
  life of the process.

``weight_quant=True`` (> :func:`quant.set_weight_quant` >
``APEX_SERVE_WEIGHT_QUANT``, default off) runs the decode matmuls on int8
weights with per-channel fp32 scales (:mod:`~apex_tpu_torch.serving.quant`,
K23 on the card); True raises when the word table is not floating point.
The records are quantized from the weights as given, before the cast to
the compute dtype (JAX quantizes the tree as the caller gave it), and sit
in the captured decode graph as static tensors; prefill stays eager and
full precision.

``kv_quant=True`` (or ``APEX_SERVE_KV_QUANT=1`` when the argument is
None) serves over the int8 KV tier (:mod:`~apex_tpu_torch.serving.
kv_tier`): int8 codes with per-(page, head) bf16 scales, quantized at
write, read by K2q.

The generation and page-pressure layers, each default off, each a
demand when passed and a preference when read from the environment:

* ``spec_decode=K`` (> ``APEX_SPEC_DECODE``): n-gram drafts of up to K
  tokens (:mod:`~apex_tpu_torch.serving.speculative`) verified in the
  packed prefill call (K1 on the card): the slot's full sequence plus its
  draft is one segment, context positions write the all-null spare row,
  the pending and draft positions write the slot's pages, and the logits
  gather reads ``K + 1`` rows a request (``_gather_w``). Greedy slots
  only; a sequence past ``prefill_len`` is not verified. K + 1 over
  ``prefill_len`` raises (the preference falls back to off); with
  ``decode_k`` > 1 two demands raise, a demand drops the other side's
  preference, and two preferences fall back to K = 1 blocks.
* ``prefix_cache=`` (> :func:`prefix_cache.set_prefix_cache` >
  ``APEX_SERVE_PREFIX_CACHE``): content-hashed refcounted page sharing
  (:mod:`~apex_tpu_torch.serving.prefix_cache`). A hit enters the slot
  by reference, its tail page is copied (:meth:`_copy_page`, in place on
  every leaf of the cache) at admission, and the covered suffix runs
  through the decode program as warm-up steps (the warm-token feed of
  ``model.decode_block`` at K > 1, the host feed at K = 1).
* ``admit=N`` (> ``APEX_SERVE_ADMIT``): :meth:`submit` returns a
  :class:`~apex_tpu_torch.serving.resilience.Rejected` when N requests
  are queued. ``shed=`` (> ``APEX_SERVE_SHED``) drops queued requests
  that waited past ``shed_ttft_ms`` (> ``APEX_SERVE_SLO_TTFT_MS`` >
  1000).
* ``preempt=`` (> ``APEX_SERVE_PREEMPT``): admission reserves the known
  stream's pages only and decode grows the tables; a refused grant
  preempts the running request of lowest priority, and re-admission
  replays its stream through the packed prefill (:meth:`_replay_prefill`).
  True raises when ``num_pages - 1 < max_pages`` (a lone request could
  not reach ``max_seq``); the preference falls back.
* ``kv_swap=`` (> ``APEX_SERVE_KV_SWAP``), with preemption on: a victim's
  pages are banked in host memory (pinned on the card, from a pool of
  staging buffers the engine reuses) at preemption and copied back in
  place at re-admission (:meth:`_swap_out_slot`,
  :meth:`_swap_in_slot`), per ``kv_restore=`` ("swap" or "recompute", >
  ``APEX_SERVE_KV_RESTORE`` > "swap"). True without preemption raises,
  and so does ``kv_restore="swap"`` without the tier. A copy that fails,
  or a handle whose bytes no longer match their seal (checked before
  anything reaches the device), falls back to the recompute replay with
  a ``swap_failed`` event; the tokens are the same either way.
* ``recover=`` (> ``APEX_SERVE_RECOVER``): every dispatch (a prefill, a
  verify, a decode program, each with the fetch of its result) runs on
  the engine's watchdog thread (:class:`~apex_tpu_torch.serving.
  resilience.Watchdog`, JAX's ``guarded_dispatch`` on a reused thread;
  ``dispatch_timeout_s=`` > ``resilience.SERVE_DISPATCH_TIMEOUT_S``). A
  round that times out (``wedged``) or raises (``degraded_relay``) is
  recovered (:meth:`_recover_round`): every unfinished request is
  requeued with a ``degraded_round`` event and replays its stream later,
  the prefix cache is flushed and the cache zeroed, and ``step`` returns
  a ``degraded`` entry. ``round_attempts=`` failed rounds in a row raise;
  ``round_retry_wait_s=`` paces them. Without the knob a failed dispatch
  propagates and the engine dies with it.
* ``overlap=`` (> ``APEX_SERVE_OVERLAP``): the overlapped round
  (:meth:`_step_overlap`) defers the decode fetch one round. Round t's
  decode program is launched and ``step`` returns; round t + 1 evicts,
  sheds and admits (and makes the prefix hits' copies) while the device
  runs, then waits for round t's tokens, copied out to pinned memory
  behind an event, and only then prefills, stages and launches. The
  scheduler's transitions are functions of token counts, not values, so
  the admissions, evictions and tokens are the serial round's;
  :meth:`flush` resolves the round in flight (``run_trace`` calls it).
  Speculation breaks the contract: ``overlap=True`` with a per-call
  ``spec_decode`` raises, and drops its preference. Preemption and
  recovery need the serial round (a requeued stream must never replay a
  placeholder token): two demands raise, a demand drops the other side's
  preference, two preferences keep the serial round.

``tp=`` above 1 raises: tensor-parallel serving is a later slice of the
port (ROADMAP.md, queue A item 7). With every layer off the engine runs
the JAX engine's configuration token for token.

The chaos sites (:mod:`apex_tpu_torch.resilience.faults`, ``APEX_FAULT_PLAN``,
for tests only): ``serve_prefill`` and ``serve_decode`` fire inside the
dispatch closures (a verify shares ``serve_prefill``), ``serve_burst`` at
the start of a serial round, ``serve_swap`` in the swap tier's copies,
``serve_alloc`` in the scheduler's page grants.

The port mutates its cache in place, and the captured decode graph holds
its addresses, so a dispatch abandoned by the watchdog must never launch
once the engine has recovered, and a round abandoned by the fleet
router's watchdog must never write once its replica was drained. The
engine keeps a round epoch (``epoch``) and one lock over its host state
and its launches. A round (``step``), ``submit``, ``flush`` and
:meth:`drain_for_failover` hold the lock; a round lets it go only while
it waits on the device (a dispatch and its fetch, a swap copy, a chaos
site, the retry pause: :meth:`_unlocked`) and, taking it back, stops
without another write if the epoch moved meanwhile (``stale_steps``).
Nothing that waits on the device runs under the lock: the inputs of a
prefill and of a decode are staged in pinned host buffers and sent with
one non-blocking copy, so a launch only enqueues. A dispatch closure
checks the epoch and enqueues its launches under the lock; recovery and
the drain bump the epoch under it and zero the cache in place on the
engine's stream, after anything a late round had already enqueued, so the
decode graph's pointers hold. An abandoned closure that wakes later finds
the epoch moved and launches nothing (``stale_dispatches`` counts them;
``abandoned_workers`` keeps their threads). A lock still held past the
dispatch budget (a launch wedged on the device) raises, naming the
``wedged`` verdict, instead of waiting for ever. Every launch of a round
runs on the engine's device and stream (``_on_stream``), whichever thread
steps the engine.

``device_dispatch_s`` accumulates the wall time of device round trips
(prefill + decode, each ending in the fetch of its tokens), so run wall
minus it is the host slice of the loop. ``events`` is the lifecycle log
(:class:`~apex_tpu_torch.serving.lifecycle.EventLog`), always kept.
"""

import contextlib
import math
import threading
import time

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch import overlap as overlap_mod
from apex_tpu_torch import resilience as res_mod
from apex_tpu_torch.resilience import faults as faults_mod
from apex_tpu_torch.serving import kv_tier, lifecycle
from apex_tpu_torch.serving import model as smodel
from apex_tpu_torch.serving import prefix_cache as prefix_mod
from apex_tpu_torch.serving import quant as quant_mod
from apex_tpu_torch.serving import resilience as serve_res
from apex_tpu_torch.serving import sampling as sampling_mod
from apex_tpu_torch.serving import speculative as spec_mod
from apex_tpu_torch.serving.kv_cache import (PageAllocator, init_cache,
                                             pages_needed)
from apex_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                              Request)
from apex_tpu_torch.serving.weights import init_gpt_params


# the sampling lanes of the decode program, in lane_arrays' order
LANES = ("temps", "top_ks", "top_ps", "keys", "counters")


class _StaleRound(BaseException):
    """A round that, waking from a wait on the device, found its engine in
    a new epoch (the failover drain took it over): it stops and writes
    nothing more. A BaseException, so no ``except Exception`` on the way
    up to ``step`` takes it for a failed copy or dispatch."""


def detokenize(tokens):
    """Toy detokenizer for smokes: token id -> letter."""
    return "".join(chr(97 + int(t) % 26) for t in tokens)


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to_device(v, device) for k, v in tree.items()}


def resolve_cuda_graph(per_call, device):
    """Whether the decode program is captured as a CUDA graph: a
    per-call bool is a demand (True needs a CUDA device, a non-bool
    raises); None means graphed on the card and eager on the CPU."""
    if per_call is not None and not isinstance(per_call, bool):
        raise ValueError(
            f"cuda_graph= wants True/False/None, got {per_call!r}")
    on_card = device.type == "cuda"
    if per_call and not on_card:
        raise ValueError(
            f"cuda_graph=True cannot be honored on {device}: a CUDA graph "
            f"needs a CUDA device")
    return on_card if per_call is None else per_call


class ServingEngine:
    def __init__(self, cfg, params=None, *, num_slots=4, page_size=16,
                 num_pages=64, max_seq=None, prefill_len=64,
                 prefill_requests=None, policy=None, seed=0, device=None,
                 kv_quant=None, kv_swap=None, kv_restore=None,
                 sampling=None, decode_k=None, cuda_graph=None,
                 weight_quant=None, spec_decode=None, prefix_cache=None,
                 admit=None, shed=None, shed_ttft_ms=None, preempt=None,
                 recover=None, overlap=None, tp=None,
                 dispatch_timeout_s=None, round_attempts=None,
                 round_retry_wait_s=None):
        smodel.check_serving_config(cfg)
        # the JAX engine's layer that comes in a later slice (ROADMAP.md,
        # queue A item 7): a value that asks for it raises
        if tp not in (None, 1):
            raise ValueError(
                f"tp={tp!r} cannot be honored: tensor-parallel serving "
                f"(tp.py) is a later slice of the port (ROADMAP.md, queue "
                f"A item 7)")
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_seq = int(max_seq or cfg.max_position_embeddings)
        if self.max_seq > cfg.max_position_embeddings:
            raise ValueError("max_seq exceeds the position table")
        self.max_pages = -(-self.max_seq // self.page_size)
        self.prefill_len = int(prefill_len)
        self.prefill_requests = int(prefill_requests or num_slots)
        self.device = default_device(device)
        self.sampling = sampling_mod.resolve(sampling)
        self.cuda_graph = resolve_cuda_graph(cuda_graph, self.device)

        # speculative decode: an un-honorable per-call draft length
        # raises, the preference falls back per shape
        k = spec_mod.resolve_k(spec_decode)
        if spec_decode is not None and k + 1 > self.prefill_len:
            raise ValueError(
                f"spec_decode={k} cannot be honored: the verify window "
                f"(K+1 = {k + 1} tokens) exceeds "
                f"prefill_len={self.prefill_len}")
        if k and k + 1 > self.prefill_len:
            k = 0  # the preference falls back per shape
        # the overlapped round cannot run under speculation (acceptance
        # depends on token values): an overlap demand drops a speculation
        # preference; against a speculation demand it raises below
        if overlap is True and k and spec_decode is None:
            k = 0
        # decode blocks and speculation both batch tokens a dispatch, and
        # the verify rollback assumes one pending token a round: two
        # demands raise, a demand drops the other side's preference, two
        # preferences fall back to K = 1
        dk = smodel.resolve_decode_k(decode_k)
        if dk > 1 and k:
            if decode_k is not None and spec_decode is not None:
                raise ValueError(
                    f"decode_k={dk} cannot be honored with "
                    f"spec_decode={k}: the verify rollback assumes one "
                    f"pending token per decode round (two demands, no "
                    f"honorable order)")
            if decode_k is not None:
                k = 0
            else:
                dk = 1
        self.spec_k, self.decode_k = k, dk
        self.spec_stats = spec_mod.SpecStats() if k else None
        # the logits gather's width a packed request: the verify chain
        # needs K + 1 rows; a plain prefill reads row r * W
        self._gather_w = self.spec_k + 1

        # preemption and round recovery need the serial round (a requeued
        # stream must never replay the overlapped round's placeholder
        # tokens): two demands raise, a demand drops the other side's
        # preference, two preferences keep the serial round
        if overlap is True and (preempt is True or recover is True):
            raise ValueError(
                "overlap=True cannot be honored with preempt=True/"
                "recover=True: the deferred-fetch round holds "
                "placeholder tokens a preempted/requeued stream would "
                "replay as values (two demands, no honorable order)")
        self.preempt = serve_res.resolve_preempt(preempt)
        self.recover = serve_res.resolve_recover(recover)
        if overlap is True:
            if preempt is None:
                self.preempt = False
            if recover is None:
                self.recover = False
        # KV-pressure preemption's progress guarantee: a lone request must
        # be able to grow to max_seq pages
        if self.preempt and self.num_pages - 1 < self.max_pages:
            if preempt is True:
                raise ValueError(
                    f"preempt=True cannot be honored: the page pool "
                    f"({self.num_pages - 1} allocatable) cannot cover "
                    f"one request's max_seq table ({self.max_pages} "
                    f"pages) — a lone preemption survivor could wedge")
            self.preempt = False
        # the int8 KV tier and the host swap tier; the swap tier banks at
        # preemption, so kv_swap=True without it raises
        self.kv_quant = kv_tier.resolve_kv_quant(kv_quant)
        self.kv_swap = kv_tier.resolve_kv_swap(kv_swap)
        if self.kv_swap and not self.preempt:
            if kv_swap is True:
                raise ValueError(
                    "kv_swap=True cannot be honored without "
                    "KV-pressure preemption (preempt=True / "
                    "APEX_SERVE_PREEMPT=1): the host tier banks pages "
                    "AT preemption — with it off nothing is ever "
                    "swapped")
            self.kv_swap = False
        if kv_restore is not None:
            kv_tier.resolve_kv_restore(kv_restore,
                                       swap_enabled=self.kv_swap)
        self.kv_restore = kv_restore
        self.kv_stats = kv_tier.KVTierStats() if self.kv_swap else None
        # rids whose swap-out failed since the last preemption drain (the
        # drain records their swap_failed between preempted and
        # resubmitted)
        self._swap_failed_rids = set()
        self.admit_limit = serve_res.resolve_admit(admit)
        self.shed = serve_res.resolve_shed(shed)
        if shed_ttft_ms is not None:
            if not isinstance(shed_ttft_ms, (int, float)) \
                    or isinstance(shed_ttft_ms, bool) or shed_ttft_ms <= 0:
                raise ValueError(
                    f"shed_ttft_ms= wants a positive number, got "
                    f"{shed_ttft_ms!r}")
            self.shed_ttft_ms = float(shed_ttft_ms)
        else:
            self.shed_ttft_ms = lifecycle.env_ms(
                "APEX_SERVE_SLO_TTFT_MS", lifecycle.DEFAULT_SLO_TTFT_MS)
        # the watchdog's budget, the failed rounds the engine survives and
        # the pause between them (explicit, so the bench attempt
        # variables never reach the serving loop)
        self.dispatch_timeout_s = float(
            dispatch_timeout_s if dispatch_timeout_s is not None
            else res_mod.SERVE_DISPATCH_TIMEOUT_S)
        self.round_attempts = int(
            round_attempts if round_attempts is not None
            else res_mod.SERVE_ROUND_ATTEMPTS)
        self._round_retry = res_mod.RetryPolicy(
            attempts=self.round_attempts,
            retry_wait_s=round_retry_wait_s
            if round_retry_wait_s is not None
            else res_mod.SERVE_ROUND_RETRY_WAIT_S)
        self._round_failures = 0   # in a row; a clean round resets it
        self.resilience = serve_res.ResilienceStats()
        self.rejected = []         # [(request, Rejected)] at submit
        self.overlap = overlap_mod.resolve_serve_overlap(
            overlap, spec_k=self.spec_k)
        if self.overlap and (self.preempt or self.recover):
            self.overlap = False   # the overlap preference falls back
        self._pending = None       # the decode round in flight (overlap)
        self._toks_host = None     # its pinned copy-out buffer (card)
        # the round epoch and the engine lock (module docstring): host
        # state is written, and a dispatch launches, only under the lock
        # and in the epoch the round started in
        self.epoch = 0
        self._lock = threading.Lock()
        self._tls = threading.local()   # .held, .epoch: this thread's hold
        self.dispatches = 0        # dispatch closures that launched
        self.stale_dispatches = 0  # abandoned ones that woke and did not
        self.stale_steps = 0       # rounds that found a new epoch
        self.abandoned_workers = []
        self._watchdog = serve_res.Watchdog("serve-dispatch")
        self.prefix_enabled = prefix_mod.resolve(prefix_cache)
        self.prefix = prefix_mod.PrefixCache(
            PageAllocator(self.num_pages), self.page_size) \
            if self.prefix_enabled else None

        params = _to_device(params, self.device) if params is not None \
            else init_gpt_params(cfg, seed, self.device)
        # weight quant: a per-call True raises when it cannot be honored;
        # the setter and env preferences defer (quant.resolve). The records
        # come from the tree as given, before the cast below
        if weight_quant is True and not quant_mod.quantizable(
                params["word_embeddings"]):
            raise ValueError(
                f"weight_quant=True cannot be honored: word_embeddings has "
                f"dtype {params['word_embeddings'].dtype}")
        self.weight_quant = quant_mod.resolve(weight_quant)
        self.qparams = smodel.quantize_decode_params(params, cfg) \
            if self.weight_quant else None
        # weights pre-cast once to the compute dtype (same numbers as a
        # cast per call; embeddings and norms stay fp32)
        self.params = smodel.cast_params(params, cfg)
        self._cache_dtype = smodel.compute_dtype(cfg)
        # the stream every launch of this engine goes on (None on the CPU)
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self.cache = self._fresh_cache()
        # the swap tier's host buffers, one set of max_pages made up front
        # (the first large pinning in a process took ~300 ms on an H100)
        self._host_pool = {name: [] for name in self.cache}
        if self.kv_swap:
            for name, leaf in self.cache.items():
                self._host_pool[name].append(
                    self._staging(name, leaf, self.max_pages))
        self.allocator = self.prefix.allocator if self.prefix is not None \
            else PageAllocator(self.num_pages)
        self.scheduler = ContinuousBatchingScheduler(
            self.num_slots, self.max_pages, self.page_size, self.allocator,
            policy=policy, prefix=self.prefix, preempt=self.preempt,
            swap_out=self._swap_out_slot if self.kv_swap else None)
        self.events = lifecycle.EventLog()
        self.tick = 0
        self.decode_steps = 0
        self.verify_calls = 0
        self.prefill_batches = 0
        self.tokens_generated = 0
        self.device_dispatch_s = 0.0
        # wall seconds of the swap tier's copies (bank and restore)
        self.swap_copy_s = 0.0
        self._init_decode_inputs()
        self._graph = self._graph_out = None
        if self.cuda_graph:
            self._capture_decode()

    def _tensor(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _fresh_cache(self):
        """A zeroed cache: the one construction home, so a rebuild can
        never drop the int8 tier's scale leaves or change the dtype."""
        return init_cache(
            self.cfg.num_layers, self.cfg.num_attention_heads,
            self.num_pages, self.page_size, self.cfg.head_dim,
            self._cache_dtype, kv_quant=self.kv_quant, device=self.device)

    def generation_stats(self):
        """Speculative acceptance rate and mean draft length, prefix-cache
        hit rate; each None when its layer is off (or before its first
        sample)."""
        st, pf = self.spec_stats, self.prefix
        return {
            "spec_acceptance_rate":
                st.acceptance_rate() if st is not None else None,
            "draft_len": st.mean_draft_len() if st is not None else None,
            "prefix_hit_rate":
                (pf.hit_tokens / pf.lookup_tokens)
                if pf is not None and pf.lookup_tokens else None,
        }

    def resilience_rates(self):
        """Shed and preempt rates and the degraded-round count (the shape
        ``lifecycle.slo_block(resilience=)`` takes), None for a layer that
        is off."""
        return self.resilience.rates(shed_on=self.shed,
                                     preempt_on=self.preempt,
                                     recover_on=self.recover)

    def kv_tier_rates(self):
        """The KV-tier account: ``kv_quant`` (True with the int8 tier on,
        None off), ``swap_rate`` (banked swap-outs over preemptions) and
        ``swapped_pages_high_water``, both None with the swap tier off."""
        quant = True if self.kv_quant else None
        st = self.kv_stats
        if st is None:
            return {"kv_quant": quant, "swap_rate": None,
                    "swapped_pages_high_water": None}
        preempted = self.resilience.preempted
        return {"kv_quant": quant,
                "swap_rate": (st.swap_outs / preempted) if preempted
                else 0.0,
                "swapped_pages_high_water": st.swapped_pages_high_water}

    # -------------------------------------------------------- front door

    def validate_request(self, request):
        """Raise on a request this engine can never serve: over the page
        budget (the scheduler's check), a prompt longer than the packed
        prefill bucket, invalid sampling parameters, or a stochastic
        demand on a sampling-off engine. (A request's threefry key is
        derived where its lane is first staged, :func:`sampling.fill_lane`.)"""
        self.scheduler.validate(request)
        if len(request.prompt) > self.prefill_len:
            raise ValueError(
                f"request {request.rid}: prompt ({len(request.prompt)} "
                f"tokens) exceeds prefill_len={self.prefill_len}")
        sp = request.sampling
        if sp is not None:
            sp.validate()
            if not sp.greedy and not self.sampling:
                raise ValueError(
                    f"request {request.rid} demands stochastic sampling "
                    f"(temperature={sp.temperature}) but the engine was "
                    f"built without sampling (sampling=True / "
                    f"APEX_SERVE_SAMPLING=1)")

    def submit(self, request, *, quiet=False, replay=False):
        """Enqueue one request and return None; impossible requests raise
        here, before anything is enqueued or allocated (before the
        admission gate, so a full queue never masks a malformed request).
        Under admission control a full queue returns a
        :class:`~apex_tpu_torch.serving.resilience.Rejected` instead, with
        nothing enqueued.

        The fleet router's hooks: ``quiet=True`` records no submitted or
        rejected event (the router owns the front of the chain on the
        fleet log); ``replay=True`` (a failover replay, load the fleet
        already accepted) also bypasses the admission bound and keeps the
        request's ``enqueue_wall``."""
        with self._hold():
            return self._submit(request, quiet, replay)

    def _submit(self, request, quiet, replay):
        self.resilience.submit_attempts += 1
        self.validate_request(request)
        if not replay and self.admit_limit \
                and self.scheduler.queue_depth() >= self.admit_limit:
            rej = serve_res.Rejected(
                "queue_full",
                max(1, -(-self.scheduler.queue_depth() // self.num_slots)))
            self.resilience.rejected += 1
            self.rejected.append((request, rej))
            if not quiet:
                wall = time.perf_counter()
                self.events.record("submitted", request.rid,
                                   tick=self.tick, wall=wall)
                self.events.record("rejected", request.rid,
                                   tick=self.tick, wall=wall)
            return rej
        if not (replay and request.enqueue_wall is not None):
            request.enqueue_wall = time.perf_counter()
        self.scheduler.submit(request, tick=self.tick)
        if not quiet:
            self.events.record("submitted", request.rid, tick=self.tick,
                               wall=request.enqueue_wall)
        return None

    # -------------------------------------------------- page-level hops

    def _copy_page(self, src, dst):
        """Copy one page ``src -> dst`` across every leaf of the cache
        (the prefix cache's tail snapshot and copy-on-write), in place,
        so the captured decode graph's tensors never move."""
        for leaf in self.cache.values():
            leaf[:, :, dst] = leaf[:, :, src]

    def _assert_writable(self, slot, first_pos, last_pos):
        """No write of any slot may land on a cache-shared page (after
        admission's copy-on-write): a failure is a prefix-cache invariant
        bug."""
        if self.prefix is None:
            return
        ps = self.page_size
        for j in range(first_pos // ps, last_pos // ps + 1):
            if j < len(slot.pages):
                assert not self.prefix.is_shared(slot.pages[j]), (
                    f"rid {slot.request.rid}: write at positions "
                    f"[{first_pos}, {last_pos}] would hit shared page "
                    f"{slot.pages[j]} (COW failed)")

    def _sync(self):
        if self._stream is not None:
            self._stream.synchronize()

    @contextlib.contextmanager
    def _on_stream(self):
        """The engine's device and stream as the current ones, in whatever
        thread runs the engine (both are per thread in PyTorch)."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    # ------------------------------------------------- the engine lock

    def _take(self):
        """Take the engine lock within the dispatch budget, else raise: a
        holder past it is a launch wedged on the device."""
        if not self._lock.acquire(timeout=self.dispatch_timeout_s):
            self.resilience.last_verdict = res_mod.WEDGED
            raise RuntimeError(
                f"the engine lock was not released within the "
                f"{self.dispatch_timeout_s}s dispatch budget (resilience."
                f"SERVE_DISPATCH_TIMEOUT_S envelope): a launch is wedged — "
                f"the device/relay is {res_mod.WEDGED}")
        self._tls.held = True

    @contextlib.contextmanager
    def _hold(self):
        """Hold the engine lock for one entry (a round, a submit, a flush,
        the failover drain), in the epoch it finds; an entry nested in
        another of the same thread holds it already."""
        tls = self._tls
        if getattr(tls, "held", False):
            yield
            return
        self._take()
        tls.epoch = self.epoch
        try:
            yield
        finally:
            if tls.held:
                tls.held = False
                self._lock.release()

    @contextlib.contextmanager
    def _unlocked(self):
        """Let the engine lock go across a wait on the device (a dispatch
        and its fetch, a swap copy, a chaos site, the retry pause) and take
        it back after. A round whose engine moved to a new epoch meanwhile
        (the failover drain took it over) stops there, writing nothing
        more (:class:`_StaleRound`)."""
        tls = self._tls
        if not getattr(tls, "held", False):
            yield
            return
        tls.held = False
        self._lock.release()
        try:
            yield
        finally:
            self._take()
            if tls.epoch != self.epoch:
                raise _StaleRound()

    # ------------------------------------------------- guarded dispatch

    def _dispatch(self, phase, launch, fetch=None):
        """One device dispatch, with the engine lock let go: ``launch()``
        enqueues the work and returns its output, ``fetch(out)`` waits for
        it. The ``serve_*`` chaos site fires first, so an injected hang
        blocks where a wedged dispatch would. The launches happen under
        the engine lock and only in the epoch the round started in: a
        closure the watchdog abandoned that wakes after recovery launches
        nothing. With ``recover`` on the closure runs under the engine's
        :class:`~apex_tpu_torch.serving.resilience.Watchdog` (a worker
        thread reused across dispatches); a timeout or an exception
        surfaces as a ``DispatchFailure``, which the round catches (its
        timed-out worker is kept in ``abandoned_workers``). Off, a failure
        propagates. A verify shares the ``serve_prefill`` site and keeps
        its own phase."""
        site = "serve_prefill" if phase == "verify" else f"serve_{phase}"
        ctx = dict(tick=self.tick, step=self.decode_steps,
                   call=self.prefill_batches)
        epoch = self.epoch

        def call():
            faults_mod.fire(site, **ctx)
            with self._lock:
                if epoch != self.epoch:
                    self.stale_dispatches += 1
                    return None
                with self._on_stream():
                    out = launch()
                self.dispatches += 1
            if fetch is not None:
                with self._on_stream():
                    out = fetch(out)
            return out

        with self._unlocked():
            if not self.recover:
                return call()
            try:
                return self._watchdog.run(call, self.dispatch_timeout_s,
                                          phase)
            except serve_res.DispatchFailure as failure:
                if failure.worker is not None:
                    self.abandoned_workers.append(failure.worker)
                raise

    def _zero_cache(self):
        """Start a new epoch and zero the cache in place on the engine's
        stream (recovery, the failover drain; the caller holds the engine
        lock): after anything an abandoned round had enqueued, and with
        the decode graph's pointers kept."""
        self.epoch += 1
        self._tls.epoch = self.epoch
        with self._on_stream():
            for leaf in self.cache.values():
                leaf.zero_()

    def _staging(self, name, leaf, n):
        """A host buffer for ``n`` pages of one cache leaf, pinned on the
        card: the smallest one in the pool (``_host_pool``) that holds
        them, else a new one of the next power of two of pages. Pinning
        costs ~0.5 ms a MB, against ~0.03 ms a MB for the copy itself (an
        H100, PERF.md), so buffers return to the pool when their handle
        is restored or dropped, and one of ``max_pages`` is made with the
        engine."""
        per_page = leaf[:, :, 0].numel()
        pool = self._host_pool[name]
        fits = [i for i, b in enumerate(pool) if b.numel() >= n * per_page]
        if fits:
            return pool.pop(min(fits, key=lambda i: pool[i].numel()))
        pages = min(1 << (n - 1).bit_length(), self.max_pages)
        return torch.empty(pages * per_page, dtype=leaf.dtype,
                           pin_memory=self.device.type == "cuda")

    def _release(self, handle):
        """Drop a banked handle: it leaves the tier's account and its
        buffers (the bases of its leaves) return to the pool."""
        self.kv_stats.released(handle)
        for name, host in handle.leaves.items():
            self._host_pool[name].append(host._base)

    def _swap_out_slot(self, slot):
        """Bank a preemption victim's live pages, every leaf of the cache,
        in host memory (pinned on the card): the scheduler's ``swap_out``
        callback, called before the pages are freed. Returns a sealed
        :class:`~apex_tpu_torch.serving.kv_tier.SwappedPages`, or None
        when the stream has no generated token (re-admission is then a
        plain prefill) or the copy failed (the ``serve_swap`` chaos site:
        the stream falls back to the recompute replay, and the drain
        records ``swap_failed``). The pages covering positions
        ``0..pos-1`` are banked, shared prefix pages' content included
        (restore writes private pages)."""
        req = slot.request
        t = slot.pos
        if not req.out_tokens or t < 1:
            return None
        n = pages_needed(t, self.page_size)
        leaves = {}
        bufs = {name: self._staging(name, leaf, n)
                for name, leaf in self.cache.items()}
        try:
            with self._unlocked():
                faults_mod.fire("serve_swap", phase="swap_out",
                                tick=self.tick, rid=req.rid)
                idx = torch.tensor(slot.pages[:n], dtype=torch.long,
                                   device=self.device)
                t0 = time.perf_counter()
                for name, leaf in self.cache.items():
                    shape = leaf.shape[:2] + (n,) + leaf.shape[3:]
                    leaves[name] = host = bufs[name][
                        :math.prod(shape)].view(shape)
                    host.copy_(leaf.index_select(2, idx))
                dt = time.perf_counter() - t0
        except BaseException as e:
            for name, buf in bufs.items():
                self._host_pool[name].append(buf)
            if not isinstance(e, Exception):
                raise
            self.kv_stats.swap_out_failures += 1
            self._swap_failed_rids.add(req.rid)
            return None
        self.swap_copy_s += dt
        handle = kv_tier.SwappedPages(leaves=leaves, page_count=n,
                                      tokens=t, quant=self.kv_quant).seal()
        self.kv_stats.banked(handle)
        return handle

    def _swap_in_slot(self, si, handle):
        """Copy one banked stream's pages back into the slot's freshly
        granted pages, in place on every leaf, and resume the slot where
        the banked content ends; True on success. False when the
        ``serve_swap`` chaos site fired or the handle's bytes no longer
        match their seal (checked before anything reaches the device):
        the handle is released, ``swap_failed`` recorded, and the caller
        replays the stream by recompute."""
        slot = self.scheduler.slots[si]
        req = slot.request
        try:
            with self._unlocked():
                faults_mod.fire("serve_swap", phase="swap_in",
                                tick=self.tick, rid=req.rid)
            if faults_mod.corrupt("serve_swap", phase="swap_in",
                                  tick=self.tick, rid=req.rid):
                # scripted host rot: one banked byte flipped in place,
                # which the seal below must catch
                raw = handle.leaves[sorted(handle.leaves)[0]].view(
                    -1).view(torch.uint8)
                raw[0] = raw[0] ^ 0xFF
            if not handle.intact():
                raise RuntimeError(
                    f"rid {req.rid}: swapped pages failed their checksum "
                    f"— banked bytes changed on the host")
            n = handle.page_count
            dst = torch.from_numpy(np.asarray(slot.pages[:n], np.int64))
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                dst = dst.pin_memory().to(self.device, non_blocking=True)
            for name, leaf in self.cache.items():
                leaf.index_copy_(2, dst, handle.leaves[name].to(
                    self.device, non_blocking=True))
            with self._unlocked():
                self._sync()
            self.swap_copy_s += time.perf_counter() - t0
        except Exception:
            self.kv_stats.swap_in_failures += 1
            self._release(handle)
            req.swapped = None
            self.events.record("swap_failed", req.rid, tick=self.tick,
                               wall=time.perf_counter())
            return False
        self.kv_stats.swap_ins += 1
        self._release(handle)
        req.swapped = None
        # pos positions are valid again; the next known token feeds the
        # first decode step (a stream banked mid-warm-up resumes inside
        # its warm-up, which the decode bookkeeping carries on)
        slot.pos = handle.tokens
        slot.next_token = int(req.resume_tokens[handle.tokens])
        return True

    def _restore_resumed(self, resumed):
        """Route each re-admitted preempted stream: ``"swap"`` restores
        its banked pages and resumes decode; ``"recompute"``, a stream
        with nothing banked, or a failed swap-in replays through the
        packed prefill. Returns the slots that need the replay."""
        sch = self.scheduler
        replay = []
        for si in resumed:
            req = sch.slots[si].request
            handle = req.swapped
            if handle is not None:
                if kv_tier.resolve_kv_restore(
                        self.kv_restore, swap_enabled=True) == "swap" \
                        and self._swap_in_slot(si, handle):
                    self.kv_stats.restores_swap += 1
                    continue
                if req.swapped is not None:
                    # recompute resolved (a failed swap-in released it)
                    self._release(handle)
                    req.swapped = None
            self.kv_stats.restores_recompute += 1
            replay.append(si)
        return replay

    # ----------------------------------------------------------- prefill

    def _pack_greedy(self, items, sizes):
        """Greedy bucket split shared by admission prefill, the replay and
        the speculative verify: a batch closes when the next packed
        sequence would overflow the ``[prefill_len]`` bucket or the
        per-batch request cap."""
        S, R = self.prefill_len, self.prefill_requests
        batches, cur, used = [], [], 0
        for item, n in zip(items, sizes):
            if cur and (used + n > S or len(cur) >= R):
                batches.append(cur)
                cur, used = [], 0
            cur.append(item)
            used += n
        if cur:
            batches.append(cur)
        return batches

    def _packed_call(self, rows, phase="prefill"):
        """ONE packed prefill call for ``rows = [(slot_idx, fed_tokens,
        write_from, gather_pos)]``: segment ids 1..R, padding and the
        positions below ``write_from`` routed to the all-null spare
        page-table row ``num_slots``, the logits gathered at each row's
        ``gather_pos`` (within its sequence) at stride ``_gather_w``, one
        guarded dispatch (``phase`` "prefill" or "verify").
        Returns ``(logits [R * W, vocab], t0)``."""
        W = self._gather_w
        # staged in the pinned host twin: the launch only enqueues its copy
        # (the previous prefill's fetch has waited for the one before)
        h = self._prefill_host_views
        ids, positions, seg = h["ids"], h["positions"], h["seg"]
        token_rows, gather_idx, pt = (h["token_rows"], h["gather"],
                                      h["page_table"])
        for a in (ids, positions, seg, gather_idx, pt):
            a[:] = 0
        token_rows[:] = self.num_slots
        pt[:self.num_slots] = self.scheduler.page_table_rows()
        cursor = 0
        for r, (si, fed, write_from, gathers) in enumerate(rows):
            n = len(fed)
            ids[cursor:cursor + n] = fed
            positions[cursor:cursor + n] = np.arange(n)
            seg[cursor:cursor + n] = r + 1
            token_rows[cursor + write_from:cursor + n] = si
            for j, gp in enumerate(gathers):
                gather_idx[r * W + j] = cursor + gp
            cursor += n
        if self.kv_quant:
            # keep_scale row (kv_tier.prefill_scatter_quant): 0 for the
            # pages this call writes afresh (stale codes there must not
            # pin the scale), 1 for pages whose content survives; a row
            # writing from write_from > 0 (a verify) keeps the page that
            # holds position write_from - 1
            keep = h["keep"]
            keep[:] = 1.0
            for si, fed, write_from, _ in rows:
                pages = self.scheduler.slots[si].pages
                first = (0 if write_from == 0
                         else (write_from - 1) // self.page_size + 1)
                for j in range(first, (len(fed) - 1) // self.page_size + 1):
                    if j < len(pages):
                        keep[pages[j]] = 0.0
        t0 = time.perf_counter()

        def launch():
            self._prefill_inputs.copy_(self._prefill_host, non_blocking=True)
            v = self._prefill_views
            return smodel.prefill(
                self.params, self.cache, v["ids"], v["positions"], v["seg"],
                v["token_rows"], v["page_table"], v["gather"],
                v["keep"] if self.kv_quant else None, cfg=self.cfg)

        def fetch(out):
            # the wait for the logits, where a wedged prefill blocks
            self._sync()
            return out

        # adopted only after a clean return
        self.cache, logits = self._dispatch(phase, launch, fetch)
        return logits, t0

    def _sample_first_tokens(self, logits_rows, requests):
        """First tokens from the prefill logits ``[R, vocab]`` (JAX's
        ``_sample_first_tokens``): the fp32 argmax with sampling off, else
        the decode program's lane semantics (counter 0, the request's own
        key), run eagerly between dispatches."""
        if not self.sampling:
            return self._fetch_tokens(torch.argmax(logits_rows.float(),
                                                   dim=-1))
        temps, top_ks, top_ps, keys, counters = sampling_mod.batch_lanes(
            requests)
        with self._unlocked():
            # the lanes' copies wait for the stream: no lock across them
            toks = sampling_mod.sample_tokens(
                logits_rows, self._tensor(temps), self._tensor(top_ks),
                self._tensor(top_ps), self._tensor(keys.astype(np.int64)),
                self._tensor(counters),
                torch.ones(len(requests), dtype=torch.bool,
                           device=self.device))
        return self._fetch_tokens(toks)

    def _fetch_tokens(self, toks):
        """Wait for a tensor of tokens and bring it to the host, with the
        engine lock let go (:meth:`_unlocked`)."""
        with self._unlocked():
            return toks.cpu().numpy()

    def _replay_prefill(self, resumed):
        """Re-admission replay of preempted streams through the packed
        prefill: each slot's known stream minus its pending last token is
        one segment writing its fresh pages, the computation that decode
        first wrote. No token is sampled (the stream is known). A stream
        longer than ``prefill_len`` replays its overflow as decode warm-up
        steps."""
        sch = self.scheduler
        items = []
        for si in resumed:
            fed = sch.slots[si].request.resume_tokens[:-1][:self.prefill_len]
            items.append((si, fed))
        for batch in self._pack_greedy(items, [len(f) for _, f in items]):
            rows = []
            for si, fed in batch:
                self._assert_writable(sch.slots[si], 0, len(fed) - 1)
                rows.append((si, fed, 0, [len(fed) - 1]))
            _, t0 = self._packed_call(rows)
            self.prefill_batches += 1
            self.device_dispatch_s += time.perf_counter() - t0
            for si, fed in batch:
                slot = sch.slots[si]
                slot.pos = len(fed)
                slot.next_token = int(slot.known[len(fed)])

    def _run_prefill(self, slot_indices):
        """Pack the newly admitted slots' prompts into ``[prefill_len]``
        batches, fill the cache, take each request's first token from its
        last prompt token's logits, and register fresh prompts with the
        prefix cache (its tail snapshots copied here). Resumed slots
        restore from the swap tier or replay first."""
        sch = self.scheduler
        resumed = [si for si in slot_indices
                   if sch.slots[si].request.resume_tokens]
        slot_indices = [si for si in slot_indices if si not in resumed]
        if resumed:
            replay = (self._restore_resumed(resumed) if self.kv_swap
                      else resumed)
            if replay:
                self._replay_prefill(replay)
        W = self._gather_w
        for batch in self._pack_greedy(
                slot_indices,
                [len(sch.slots[si].request.prompt) for si in slot_indices]):
            rows = [(si, sch.slots[si].request.prompt, 0,
                     [len(sch.slots[si].request.prompt) - 1])
                    for si in batch]
            logits, t0 = self._packed_call(rows)
            self.prefill_batches += 1
            # rows r * W hold each request's last-prompt-token logits
            next_toks = self._sample_first_tokens(
                logits[:len(batch) * W:W],
                [sch.slots[si].request for si in batch])
            wall = time.perf_counter()
            self.device_dispatch_s += wall - t0
            for r, si in enumerate(batch):
                slot = sch.slots[si]
                req = slot.request
                slot.pos = len(req.prompt)
                tok = int(next_toks[r])
                req.out_tokens.append(tok)
                slot.next_token = tok
                self.tokens_generated += 1
                # prefill samples the request's FIRST token: this fetch's
                # wall is the TTFT stamp
                if req.first_token_wall is None:
                    req.first_token_wall = wall
                self.events.record("prefill_done", req.rid, tick=self.tick,
                                   wall=wall)
                self.events.record("first_token", req.rid, tick=self.tick,
                                   wall=wall)
                if req.done():
                    req.finish_wall = wall
                    self.events.record("finished", req.rid, tick=self.tick,
                                       wall=wall)
                if self.prefix is not None:
                    adopted, copies = self.prefix.register(
                        req.prompt, slot.pages, ("req", req.rid))
                    if adopted:
                        self.prefix.acquire(adopted)
                        slot.shared_pages.extend(adopted)
                    for src, dst in copies:
                        self._copy_page(src, dst)
        return resumed + slot_indices

    # ------------------------------------------------------- speculative

    def _propose_drafts(self, active):
        """``[(slot_idx, draft)]`` for every greedy slot past its known
        stream whose n-gram draft exists and fits the remaining token
        budget, ``prefill_len`` and ``max_seq``. Sampled slots never
        draft."""
        sch = self.scheduler
        out = []
        for i in active:
            slot = sch.slots[i]
            req = slot.request
            if req.done() or slot.pos < len(slot.known):
                continue
            sp = req.sampling
            if sp is not None and not sp.greedy:
                continue
            remaining = req.max_new_tokens - len(req.out_tokens)
            k = min(self.spec_k, remaining - 1,
                    self.prefill_len - slot.pos - 1,
                    self.max_seq - slot.pos - 1)
            if k < 1:
                continue
            draft = spec_mod.propose(req.prompt + req.out_tokens, k)
            if draft:
                out.append((i, draft))
        return out

    def _run_verify(self, drafts):
        """Verify drafted slots in packed prefill calls: each slot's full
        sequence plus its draft is one segment; context positions write
        the null spare row (the decode-written K/V stay as they are), the
        pending and draft positions write the slot's pages, and the gather
        reads the K + 1 verify logits. A slot gains 1..K + 1 tokens
        (``speculative.accept``). Returns the verified slots."""
        sch = self.scheduler
        W = self._gather_w
        verified = []
        for batch in self._pack_greedy(
                drafts, [sch.slots[i].pos + 1 + len(d) for i, d in drafts]):
            rows = []
            for i, draft in batch:
                slot = sch.slots[i]
                req = slot.request
                fed = req.prompt + req.out_tokens + draft
                pos = slot.pos
                assert len(fed) == pos + 1 + len(draft), (
                    len(fed), pos, len(draft))
                self._assert_writable(slot, pos, len(fed) - 1)
                rows.append((i, fed, pos,
                             list(range(pos, pos + len(draft) + 1))))
            logits, t0 = self._packed_call(rows, phase="verify")
            self.verify_calls += 1
            greedy = self._fetch_tokens(torch.argmax(logits.float(), dim=-1))
            wall = time.perf_counter()
            self.device_dispatch_s += wall - t0
            for r, (i, draft) in enumerate(batch):
                slot = sch.slots[i]
                req = slot.request
                chain = [int(t) for t in
                         greedy[r * W:r * W + len(draft) + 1]]
                added = spec_mod.accept(draft, chain)
                assert len(added) <= req.max_new_tokens \
                    - len(req.out_tokens), (req.rid, added)
                self.spec_stats.record(len(draft), len(added) - 1)
                req.out_tokens.extend(added)
                slot.pos = len(req.prompt) + len(req.out_tokens) - 1
                slot.next_token = req.out_tokens[-1]
                self.tokens_generated += len(added)
                if req.done():
                    req.finish_wall = wall
                    self.events.record("finished", req.rid, tick=self.tick,
                                       wall=wall)
                verified.append(i)
        return verified

    # ------------------------------------------------------------ decode

    def _staged(self, fields):
        """Inputs staged on the host and sent in one copy: one int32 buffer
        on the device with a named view per ``(name, shape)`` field (the
        fp32 fields stored as their bits, each field at a 64-byte offset)
        and its host twin, pinned on the card, so the copy enqueues
        without waiting. Returns ``(host, device, host views, device
        views)``."""
        offsets, o = [], 0
        for _, shape in fields:
            offsets.append(o)
            o += -(-int(np.prod(shape)) // 16) * 16
        host = torch.zeros(o, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        dev = torch.zeros(o, dtype=torch.int32, device=self.device)
        flat = host.numpy()
        host_views, views = {}, {}
        for (name, shape), o in zip(fields, offsets):
            n = int(np.prod(shape))
            hv, dv = flat[o:o + n], dev[o:o + n]
            if name in ("temps", "top_ps", "keep"):
                hv, dv = hv.view(np.float32), dv.view(torch.float32)
            elif name == "keys":
                hv = hv.view(np.uint32)
            host_views[name] = hv.reshape(shape)
            views[name] = dv.view(shape)
        return host, dev, host_views, views

    def _init_decode_inputs(self):
        """The staged inputs (:meth:`_staged`) of the decode program
        (``_inputs``, filled each round in ``_host_views``) and of the
        packed prefill (``_prefill_inputs``)."""
        B, P, K = self.num_slots, self.max_pages, self.decode_k
        (self._host_inputs, self._inputs, self._host_views,
         self._views) = self._staged((
             ("tokens", (B,)), ("lengths", (B,)), ("page_table", (B, P)),
             ("steps", (B,)), ("warm_steps", (B,)), ("warm_tokens", (K, B)),
             ("temps", (B,)), ("top_ks", (B,)), ("top_ps", (B,)),
             ("keys", (B, 2)), ("counters", (B,))))
        S = self.prefill_len
        (self._prefill_host, self._prefill_inputs, self._prefill_host_views,
         self._prefill_views) = self._staged((
             ("ids", (S,)), ("positions", (S,)), ("seg", (S,)),
             ("token_rows", (S,)), ("page_table", (B + 1, P)),
             ("gather", (self.prefill_requests * self._gather_w,)),
             ("keep", (self.num_pages,))))

    def _decode_program(self):
        """ONE decode program over the staged inputs: ``decode_step`` (K =
        1) or ``decode_block`` (K > 1), with the sampler when sampling is
        on; no host read, so it can be captured. Returns the tokens,
        ``[B]`` or ``[K, B]`` int32."""
        v = self._views
        lanes = tuple(v[n] for n in LANES) if self.sampling else None
        if self.decode_k > 1:
            _, toks, _ = smodel.decode_block(
                self.params, self.cache, v["tokens"], v["lengths"],
                v["page_table"], v["steps"], v["warm_tokens"],
                v["warm_steps"], lanes, k=self.decode_k, cfg=self.cfg,
                qparams=self.qparams)
            return toks
        _, toks, logits = smodel.decode_step(
            self.params, self.cache, v["tokens"], v["lengths"],
            v["page_table"], cfg=self.cfg, qparams=self.qparams)
        if lanes is not None:
            toks = sampling_mod.sample_tokens(logits, *lanes,
                                              v["lengths"] > 0)
        return toks

    def _cache_ptrs(self):
        return [t.data_ptr() for t in self.cache.values()]

    def _capture_decode(self):
        """Capture the decode program once as a CUDA graph on a side
        stream, after one warm-up call there on the all-zero inputs (every
        lane inactive: its writes go to null page 0). The warm-up builds
        and loads the kernels, grants their shared memory, and allocates
        decode attention's ticket array for the capture stream, so the
        capture records only launches; the kernel leaves the tickets zero,
        so every replay finds them so. A failed capture raises."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._decode_program()
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = self._decode_program()
        self._graph, self._graph_out = graph, out
        self._graph_cache = self._cache_ptrs()

    def _lane_budget(self, slot):
        """``(warm-up steps left, this block's step budget)`` for one live
        lane: warm-up steps consume known tokens (a prefix hit's covered
        suffix, a resumed stream's overflow past ``prefill_len``; their
        outputs are discarded), then the lane emits toward its remaining
        new tokens. The budget caps at ``decode_k`` and at the lane's
        finish, so block writes stay within the request's
        ``prompt + max_new_tokens`` pages."""
        req = slot.request
        warm = max(0, len(slot.known) - 1 - slot.pos)
        rem = req.max_new_tokens - len(req.out_tokens)
        return warm, min(self.decode_k, warm + rem)

    def _block_hi(self, slot):
        """Highest cache position this block writes for a live lane (at
        K = 1 exactly ``slot.pos``)."""
        return slot.pos + self._lane_budget(slot)[1] - 1

    def _stage_block(self, decode_lanes):
        """Per-lane staging of one K-block (JAX's ``_stage_block``) into
        the host twin: ``steps`` (the device budget; 0 for a lane that
        finished at this round's prefill, ballast for the whole block),
        ``warm_steps`` and the warm-token feed ``warm_tokens [K, B]``.
        Returns ``steps``, lane -> the steps its bookkeeping consumes."""
        sch = self.scheduler
        h = self._host_views
        h["steps"][:] = 0
        h["warm_steps"][:] = 0
        h["warm_tokens"][:] = 0
        steps = {}
        for i in decode_lanes:
            slot = sch.slots[i]
            if slot.request.done():
                steps[i] = 1  # ballast: one count step, no device step
                continue
            warm, budget = self._lane_budget(slot)
            steps[i] = h["steps"][i] = budget
            w = min(warm, budget)
            h["warm_steps"][i] = w
            for j in range(w):
                h["warm_tokens"][j, i] = int(slot.known[slot.pos + j + 1])
            self._assert_writable(slot, slot.pos, slot.pos + budget - 1)
        return steps

    def _stage_inputs(self, decode_lanes, zero_length_lanes=()):
        """Fill the host twin with this round's tokens, lengths (0 for the
        lanes this round's verify served), page table, block budgets and
        sampling lanes; returns ``steps``."""
        sch = self.scheduler
        h = self._host_views
        tokens, lengths = sch.decode_inputs()
        for i in zero_length_lanes:
            lengths[i] = 0
        h["tokens"][:] = tokens
        h["lengths"][:] = lengths
        h["page_table"][:] = sch.page_table_rows()
        if self.decode_k > 1:
            steps = self._stage_block(decode_lanes)
        else:
            steps = {i: 1 for i in decode_lanes}
            for i in decode_lanes:
                slot = sch.slots[i]
                self._assert_writable(slot, slot.pos, slot.pos)
        if self.sampling:
            for name, arr in zip(LANES, sampling_mod.lane_arrays(
                    sch.slots, self.num_slots)):
                h[name][:] = arr
        return steps

    def _dispatch_decode(self, decode_lanes, zero_length_lanes=(),
                         defer=False):
        """Stage and run ONE decode program for the current slots (a
        graph replay, or the eager call) as one guarded dispatch; returns
        ``(next_toks, t0, steps)``. A graph's output is overwritten by the
        next replay, so it is fetched before the next dispatch: inside
        the dispatch (host numpy; inside the watchdog with ``recover``),
        or with ``defer`` (the overlapped round) copied out behind an
        event (:meth:`_copy_out`)."""
        steps = self._stage_inputs(decode_lanes, zero_length_lanes)
        t0 = time.perf_counter()

        def launch():
            self._inputs.copy_(self._host_inputs, non_blocking=True)
            if self._graph is None:
                out = self._decode_program()
            else:
                if self._cache_ptrs() != self._graph_cache:
                    raise RuntimeError(
                        "the KV cache moved since the decode graph was "
                        "captured: its writes must stay in place")
                self._graph.replay()
                out = self._graph_out
            return self._copy_out(out) if defer else out

        next_toks = self._dispatch(
            "decode", launch,
            None if defer else self._fetch_tokens)
        return next_toks, t0, steps

    def _copy_out(self, toks):
        """The overlapped round's deferred fetch: on the card the tokens
        are copied into a pinned host buffer without waiting, behind an
        event the resolve waits on (``_resolve_pending``, before the next
        dispatch can overwrite either); on the CPU the tensor itself.
        Returns ``(tokens, event or None)``."""
        if self._stream is None:
            return toks, None
        if self._toks_host is None or self._toks_host.shape != toks.shape:
            self._toks_host = torch.empty(toks.shape, dtype=toks.dtype,
                                          pin_memory=True)
        self._toks_host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        return self._toks_host, event

    def _advance_counts(self, decode_lanes, steps):
        """Count bookkeeping of one decode block, walking its (step, lane)
        grid: every consumed step advances the lane's position; a warm-up
        step (the consumed token was a known token with more to come)
        feeds the next known token and emits nothing; otherwise a lane
        short of its budget gets a placeholder token that
        :meth:`_fill_plan` fills (a lane that finished at this round's
        prefill rides as ballast). Returns ``(plan, decoded)``."""
        sch = self.scheduler
        plan = []
        decoded = 0
        for j in range(self.decode_k):
            for i in decode_lanes:
                if j >= steps.get(i, 0):
                    continue
                slot = sch.slots[i]
                req = slot.request
                k_len = len(slot.known)
                consumed_pos = slot.pos
                slot.pos += 1
                if consumed_pos < k_len - 1:
                    # warm-up: fed on the host at K = 1, by the staged
                    # warm_tokens row inside the block at K > 1
                    slot.next_token = int(slot.known[consumed_pos + 1])
                    decoded += 1
                    continue
                if not req.done():
                    req.out_tokens.append(None)   # the value lands at fill
                    self.tokens_generated += 1
                    plan.append({
                        "lane": i, "step": j, "slot": slot, "req": req,
                        "out_idx": len(req.out_tokens) - 1,
                        # the slot's first output token (a prefix hit's
                        # warm-up just ended): the prefill-done and
                        # first-token seam; a resumed stream had its own
                        "first": (consumed_pos == k_len - 1
                                  and req.first_token_wall is None),
                        "done": req.done()})
                decoded += 1
        self.decode_steps += 1
        return plan, decoded

    def _fill_plan(self, plan, next_toks, wall, tick):
        """The value half of the round bookkeeping: fill the placeholder
        tokens (``next_toks`` ``[B]``, or ``[K, B]`` from a block, indexed
        by (step, lane)) and stamp the walls and events. A lane with
        several tokens in a block fills in step order, so its
        ``next_token`` is the last step's."""
        toks = np.asarray(next_toks)
        if toks.ndim == 1:
            toks = toks[None]
        for e in plan:
            tok = int(toks[e["step"], e["lane"]])
            req = e["req"]
            req.out_tokens[e["out_idx"]] = tok
            e["slot"].next_token = tok
            if e["first"]:
                if req.first_token_wall is None:
                    req.first_token_wall = wall
                self.events.record("prefill_done", req.rid, tick=tick,
                                   wall=wall)
                self.events.record("first_token", req.rid, tick=tick,
                                   wall=wall)
            if e["done"]:
                if req.finish_wall is None:
                    req.finish_wall = wall
                self.events.record("finished", req.rid, tick=tick,
                                   wall=wall)

    # ------------------------------------------------------------- rounds

    def _sample_gauges(self, tick):
        """One gauge sample a round, after its device work."""
        sch = self.scheduler
        wall = time.perf_counter()
        st, pf, rs = self.spec_stats, self.prefix, self.resilience
        self.events.sample_gauges(
            tick=tick, wall=wall,
            slots_active=len(sch.active_indices()),
            num_slots=self.num_slots,
            queue_depth=sch.queue_depth(),
            kv_pages_live=(self.allocator.num_pages - 1
                           - self.allocator.free_count),
            kv_pages_total=self.allocator.num_pages,
            hol_wait_s=sch.head_of_line_wait(wall, tick=tick),
            spec_drafted=st.drafted if st is not None else 0,
            spec_accepted=st.accepted if st is not None else 0,
            prefix_hit_tokens=pf.hit_tokens if pf is not None else 0,
            rejected=rs.rejected, shed=rs.shed, preempted=rs.preempted,
            resubmitted=rs.resubmitted, degraded_rounds=rs.degraded_rounds)

    def _shed_queue(self, tick, wall):
        """Drop queued requests that waited past ``shed_ttft_ms``: their
        TTFT is at least their wait, so their SLO is lost. A request with a
        first token already (a requeued preemption victim) is never
        shed."""
        sch = self.scheduler
        dropped = []
        for req in list(sch.queue):
            if req.first_token_wall is not None \
                    or req.enqueue_wall is None:
                continue
            if (wall - req.enqueue_wall) * 1e3 > self.shed_ttft_ms:
                sch.queue.remove(req)
                req.shed_tick = tick
                sch.shed.append(req)
                self.resilience.shed += 1
                dropped.append(req)
                self.events.record("shed", req.rid, tick=tick, wall=wall)
        return dropped

    def _drain_preempted(self, tick):
        """Events and counters of the requests the scheduler preempted
        since the last drain."""
        preempted = self.scheduler.take_preempted()
        for req in preempted:
            self.resilience.preempted += 1
            self.resilience.resubmitted += 1
            wall = time.perf_counter()
            self.events.record("preempted", req.rid, tick=tick, wall=wall)
            if req.rid in self._swap_failed_rids:
                # the swap-out failed: the stream resubmits all the same
                # and replays by recompute
                self.events.record("swap_failed", req.rid, tick=tick,
                                   wall=wall)
            self.events.record("resubmitted", req.rid, tick=tick,
                               wall=wall)
            self._swap_failed_rids.discard(req.rid)
        return preempted

    def _ensure_pages(self, lanes_pos, tick):
        """Grow every lane's table to cover its highest write position
        this round, preempting on a refused grant. Returns the lanes still
        seated (a lane preempted to make room drops out of the round)."""
        sch = self.scheduler
        alive = []
        for i, hi in lanes_pos:
            if sch.slots[i] is None:
                continue  # preempted by an earlier lane's growth
            if sch.grow(i, hi // self.page_size + 1, tick):
                alive.append(i)
        self._drain_preempted(tick)
        return [i for i in alive if sch.slots[i] is not None]

    def step(self, arrivals=None, *, epoch=None):
        """One scheduler round under the engine lock: the serial round
        (:meth:`_step_serial`), or the overlapped one with ``overlap`` on.
        Returns a dict of what happened. ``epoch`` is the fleet router's:
        a round it started before a failover drain (its watchdog abandoned
        it) finds the engine's epoch moved, does nothing and returns None;
        so does a round the drain took the engine from while it waited on
        the device."""
        with self._hold():
            if epoch is not None and epoch != self.epoch:
                self.stale_steps += 1
                return None
            try:
                with self._on_stream():
                    if self.overlap:
                        return self._step_overlap(arrivals)
                    return self._step_serial(arrivals)
            except _StaleRound:
                self.stale_steps += 1
                return None

    def _fire_burst(self, tick):
        """The ``serve_burst`` chaos site: build the scripted storm of
        requests and submit it through the real front door."""
        spec = faults_mod.burst("serve_burst", tick=tick)
        if not spec:
            return
        base = int(spec.get("rid_base", 9_000_000))
        plen = int(spec.get("prompt_len", 4))
        for j in range(int(spec.get("count", 8))):
            self.submit(Request(
                rid=base + j, prompt=[1 + (j % 7)] * plen,
                max_new_tokens=int(spec.get("max_new", 4)),
                arrival=float(tick)))

    def _step_serial(self, arrivals=None):
        """The serial round: the burst site, due arrivals, then
        :meth:`_round_serial`; a ``DispatchFailure`` (only a guarded
        dispatch raises one) is recovered (:meth:`_recover_round`)."""
        now = self.tick
        self._fire_burst(now)
        for req in arrivals or ():
            self.submit(req)
        try:
            result = self._round_serial(now)
        except serve_res.DispatchFailure as failure:
            return self._recover_round(now, failure)
        self._round_failures = 0
        return result

    def _round_serial(self, now):
        """Evict, shed, admit (prefix hits' copies, then prefill or
        restore the rest), verify the drafted slots, grow the tables under
        preemption, decode every other seated slot."""
        sch = self.scheduler
        wall = time.perf_counter()
        evicted = sch.evict_done(now, wall)
        shed = self._shed_queue(now, wall) if self.shed else []
        admitted = sch.admit(now, wall)
        for r in evicted:
            self.events.record("evicted", r.rid, tick=now, wall=wall)
        for i in admitted:
            self.events.record("admitted", sch.slots[i].request.rid,
                               tick=now, wall=wall)
        self.resilience.admissions += len(admitted)
        # prefix hits skip the prefill: their copies run here, before any
        # write, and their covered suffix runs through decode below
        to_prefill = []
        for i in admitted:
            slot = sch.slots[i]
            if slot.prefix_hit:
                for src, dst in slot.cow_copies:
                    self._copy_page(src, dst)
                slot.cow_copies = []
            else:
                to_prefill.append(i)
        prefilled = self._run_prefill(to_prefill) if to_prefill else []
        active = sch.active_indices()
        verified = []
        if self.spec_k and active:
            drafts = self._propose_drafts(active)
            if self.preempt and drafts:
                # the verify writes pos..pos+|draft|: grow first (a lane
                # preempted meanwhile drops its draft)
                alive = set(self._ensure_pages(
                    [(i, sch.slots[i].pos + len(d)) for i, d in drafts],
                    now))
                drafts = [(i, d) for i, d in drafts if i in alive]
            if drafts:
                verified = self._run_verify(drafts)
            active = sch.active_indices()
        decode_lanes = [i for i in active if i not in verified]
        if self.preempt and decode_lanes:
            # grow for each live lane's writes; a lane that finished at
            # this round's prefill writes the null page and needs none
            grown = set(self._ensure_pages(
                [(i, self._block_hi(sch.slots[i])) for i in decode_lanes
                 if not sch.slots[i].request.done()], now))
            decode_lanes = [i for i in decode_lanes
                            if sch.slots[i] is not None
                            and (sch.slots[i].request.done()
                                 or i in grown)]
        decoded = 0
        if decode_lanes:
            next_toks, t0, steps = self._dispatch_decode(
                decode_lanes, zero_length_lanes=verified)
            wall2 = time.perf_counter()
            self.device_dispatch_s += wall2 - t0
            # the count bookkeeping after the fetch: a round abandoned in
            # its fetch leaves no placeholder token for a drain to replay
            plan, decoded = self._advance_counts(decode_lanes, steps)
            self._fill_plan(plan, next_toks, wall2, now)
        self._sample_gauges(now)
        # a slot whose LAST token was just produced frees at the next
        # round's evict
        self.tick += 1
        return {"tick": now, "evicted": [r.rid for r in evicted],
                "admitted": admitted, "prefilled": prefilled,
                "verified": verified, "decoded_slots": decoded,
                "shed": [r.rid for r in shed]}

    # ------------------------------------------------------ round recovery

    def _recover_round(self, now, failure):
        """Round recovery (JAX's ``_recover_round``): a dispatch the
        watchdog timed out or caught raising does not kill the engine.
        Every unfinished seated request is requeued (pages freed, its
        known stream kept for the replay; nothing banked, the cache is
        what is no longer trusted) with ``degraded_round`` and
        ``resubmitted`` events; a request that already finished stays
        seated for the next evict. The finished slots' prefix references
        are released and the prefix cache flushed (its chains point into
        the cache), and the cache is zeroed in place in a new epoch
        (:meth:`_zero_cache`), so an abandoned dispatch launches nothing
        after this. ``round_attempts`` failed rounds in a row raise; the
        retry policy's wait paces the next one."""
        sch = self.scheduler
        self._round_failures += 1
        self.resilience.degraded_rounds += 1
        self.resilience.last_verdict = failure.verdict
        requeued = [sch.requeue_slot(i, now, swap=False)
                    for i in sch.active_indices()
                    if not sch.slots[i].request.done()]
        if self.prefix is not None:
            for i in sch.active_indices():
                slot = sch.slots[i]
                if slot.shared_pages:
                    self.prefix.release(slot.shared_pages)
                    slot.shared_pages = []
            self.prefix.flush()
        self._zero_cache()
        wall = time.perf_counter()
        for req in requeued:
            self.events.record("degraded_round", req.rid, tick=now,
                               wall=wall)
            self.events.record("resubmitted", req.rid, tick=now, wall=wall)
        self.resilience.resubmitted += len(requeued)
        if self._round_failures >= self.round_attempts:
            raise RuntimeError(
                f"serving round failed {self._round_failures} "
                f"consecutive times (last: {failure}) — the "
                f"SERVE_ROUND_ATTEMPTS budget is exhausted; the "
                f"device/relay is {failure.verdict}") from failure
        wait = self._round_retry.pop_wait()
        if wait:
            with self._unlocked():
                time.sleep(wait)
        self._sample_gauges(now)
        self.tick += 1
        return {"tick": now, "evicted": [], "admitted": [],
                "prefilled": [], "verified": [], "decoded_slots": 0,
                "shed": [],
                "degraded": {"phase": failure.phase,
                             "verdict": failure.verdict,
                             "detail": failure.detail,
                             "requeued": [r.rid for r in requeued]}}

    def drain_for_failover(self, tick):
        """Evacuate this replica for the fleet router's failover: finished
        slots settle through the normal evict, every queued and in-flight
        request leaves in replayable form (in-flight ones requeued as in
        recovery, the oldest streams first), the prefix cache is flushed,
        the cache zeroed in a new epoch and the failure count reset.
        Returns the drained requests for ``submit(..., replay=True)`` on a
        survivor; the router records their failover events.

        It holds the engine lock, so it runs between a round's writes: a
        round the router's watchdog abandoned while it waited on the
        device stops when it wakes (the new epoch), and holds no
        placeholder token then (the serial round counts its decode after
        the fetch; the router refuses an overlapped engine)."""
        with self._hold():
            sch = self.scheduler
            wall = time.perf_counter()
            for r in sch.evict_done(tick, wall):
                self.events.record("evicted", r.rid, tick=tick, wall=wall)
            queued = list(sch.queue)
            sch.queue.clear()
            # nothing banked: the requests replay on another replica
            inflight = [sch.requeue_slot(i, tick, swap=False)
                        for i in sch.active_indices()]
            sch.queue.clear()   # the router decides where they go
            if self.prefix is not None:
                self.prefix.flush()
            self._zero_cache()
            self._round_failures = 0
            drained = inflight + queued
            for req in drained:
                if req.swapped is not None:
                    self._release(req.swapped)
                    req.swapped = None
            return drained

    # ------------------------------------------------ the overlapped round

    def _resolve_pending(self):
        """The overlapped round's sync point: wait for the round in
        flight's tokens and fill them in (stamped with the tick of the
        round that launched it)."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        toks, event = p["next_toks"]
        if event is not None:
            with self._unlocked():
                event.synchronize()
        next_toks = toks.numpy().copy()
        wall = time.perf_counter()
        # the planning between the launch and this wait ran while the
        # device worked: it counts as dispatch wall
        self.device_dispatch_s += wall - p["t0"]
        self._fill_plan(p["plan"], next_toks, wall, p["tick"])

    def flush(self):
        """Resolve the decode round in flight (overlapped round): its
        placeholder tokens and their events land. A no-op otherwise;
        ``run_trace`` calls it, a caller driving ``step`` calls it before
        reading ``out_tokens``."""
        with self._hold(), self._on_stream():
            try:
                self._resolve_pending()
            except _StaleRound:
                pass

    def _step_overlap(self, arrivals=None):
        """The overlapped round (JAX's ``_step_overlap``): evict, shed and
        admit (count state only; a prefix hit's copies are enqueued on the
        engine's stream, behind the decode in flight) while the device
        runs round t, then wait for round t's tokens, record the
        evictions after their finished events, prefill, and launch round
        t + 1's decode, returning with it in flight."""
        sch = self.scheduler
        now = self.tick
        for req in arrivals or ():
            self.submit(req)
        wall = time.perf_counter()
        # finish_wall belongs to the fetch that produced the last token
        evicted = sch.evict_done(now, None)
        shed = self._shed_queue(now, wall) if self.shed else []
        admitted = sch.admit(now, wall)
        for i in admitted:
            self.events.record("admitted", sch.slots[i].request.rid,
                               tick=now, wall=wall)
        to_prefill = []
        for i in admitted:
            slot = sch.slots[i]
            if slot.prefix_hit:
                for src, dst in slot.cow_copies:
                    self._copy_page(src, dst)
                slot.cow_copies = []
            else:
                to_prefill.append(i)
        self._resolve_pending()
        for r in evicted:
            if r.finish_wall is None:
                r.finish_wall = wall
        if evicted:
            wall_e = time.perf_counter()
            for r in evicted:
                self.events.record("evicted", r.rid, tick=now, wall=wall_e)
        prefilled = self._run_prefill(to_prefill) if to_prefill else []
        decode_lanes = sch.active_indices()
        decoded = 0
        if decode_lanes:
            next_toks, t0, steps = self._dispatch_decode(decode_lanes,
                                                         defer=True)
            plan, decoded = self._advance_counts(decode_lanes, steps)
            self._pending = {"next_toks": next_toks, "plan": plan,
                             "t0": t0, "tick": now}
        self._sample_gauges(now)
        self.tick += 1
        return {"tick": now, "evicted": [r.rid for r in evicted],
                "admitted": admitted, "prefilled": prefilled,
                "verified": [], "decoded_slots": decoded,
                "shed": [r.rid for r in shed]}

    def run_trace(self, requests, max_ticks=10000):
        """Replay a trace to completion: each request is submitted when
        its arrival tick is due. A request settles by completing, being
        shed, or being rejected at submit. Flushes the overlapped round in
        flight before returning. Returns the completed requests (latency
        stamps filled)."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        trace_ids = {id(r) for r in requests}
        sch = self.scheduler

        def settled():
            return (sum(id(r) in trace_ids for r in sch.completed)
                    + sum(id(r) in trace_ids for r, _ in self.rejected)
                    + sum(id(r) in trace_ids for r in sch.shed))

        while settled() < len(requests):
            if self.tick >= max_ticks:
                raise RuntimeError(
                    f"trace did not drain in {max_ticks} ticks "
                    f"({settled()}/{len(requests)} settled)")
            due = [r for r in pending if r.arrival <= self.tick]
            pending = [r for r in pending if r.arrival > self.tick]
            self.step(arrivals=due)
        self.flush()
        return list(sch.completed)
