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
  one program (:func:`model.decode_block`). Each lane's budget is
  ``min(K, its remaining tokens)``; admission and eviction happen at block
  boundaries; a lane that finishes mid-block rides the rest of the block
  masked (its writes go to null page 0, its tokens are discarded). The
  warm-token feed stays zero: the prefix cache and preemption that supply
  it are later slices. On the card K > 1 buys nothing over the graph
  below, which already spreads the per-dispatch cost that the block
  exists to spread (graphed K = 4 measured 0.89-1.08x graphed K = 1's
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
write, read by K2q. The JAX engine's other layers — speculative decode,
the prefix cache, the overlapped round, admission control, shedding,
preemption, round recovery, the host swap tier and tensor parallelism —
are later slices (ROADMAP.md); ``kv_swap=True`` and
``kv_restore="swap"`` raise, as the JAX engine raises on them without
preemption. This engine runs the JAX engine's configuration with those
layers off, token for token.

``device_dispatch_s`` accumulates the wall time of device round trips
(prefill + decode, each ending in the fetch of its tokens), so run wall
minus it is the host slice of the loop. ``events`` is the lifecycle log
(:class:`~apex_tpu_torch.serving.lifecycle.EventLog`), always kept.
"""

import time

import numpy as np
import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.serving import kv_tier, lifecycle
from apex_tpu_torch.serving import model as smodel
from apex_tpu_torch.serving import quant as quant_mod
from apex_tpu_torch.serving import sampling as sampling_mod
from apex_tpu_torch.serving.kv_cache import PageAllocator, init_cache
from apex_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from apex_tpu_torch.serving.weights import init_gpt_params


# the sampling lanes of the decode program, in lane_arrays' order
LANES = ("temps", "top_ks", "top_ps", "keys", "counters")


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
                 weight_quant=None):
        smodel.check_serving_config(cfg)
        # the int8 KV tier: a per-call demand, else the env preference,
        # else off. kv_swap and kv_restore exist only to be refused: the
        # host swap tier banks pages at KV-pressure preemption, which this
        # engine does not have (the JAX engine raises on kv_swap=True
        # without preemption); with no preemption nothing is restored, so
        # "recompute" is accepted and changes nothing
        self.kv_quant = kv_tier.resolve_kv_quant(kv_quant)
        if kv_swap:
            raise ValueError(
                "kv_swap=True cannot be honored: the host swap tier banks "
                "pages at KV-pressure preemption, which this engine does "
                "not have")
        if kv_restore is not None:
            if kv_restore not in kv_tier.RESTORE_CHOICES:
                raise ValueError(f"unknown kv_restore {kv_restore!r} "
                                 f"(vocabulary: {kv_tier.RESTORE_CHOICES})")
            if kv_restore == "swap":
                raise ValueError(
                    "kv_restore='swap' demanded but the host swap tier is "
                    "off — no honorable way to restore from pages that "
                    "were never banked")
        self.device = default_device(device)
        self.sampling = sampling_mod.resolve(sampling)
        self.decode_k = smodel.resolve_decode_k(decode_k)
        self.cuda_graph = resolve_cuda_graph(cuda_graph, self.device)
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
        self.cache = self._fresh_cache()
        self.allocator = PageAllocator(self.num_pages)
        self.scheduler = ContinuousBatchingScheduler(
            self.num_slots, self.max_pages, self.page_size, self.allocator,
            policy=policy)
        self.events = lifecycle.EventLog()
        self.tick = 0
        self.decode_steps = 0
        self.prefill_batches = 0
        self.tokens_generated = 0
        self.device_dispatch_s = 0.0
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

    def kv_tier_rates(self):
        """The KV-tier account: ``kv_quant`` (True with the int8 tier on,
        None off); ``swap_rate`` and ``swapped_pages_high_water`` are None,
        as the host swap tier is off."""
        return {"kv_quant": True if self.kv_quant else None,
                "swap_rate": None, "swapped_pages_high_water": None}

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

    def submit(self, request):
        """Enqueue one request; impossible requests raise here, before
        anything is enqueued or allocated."""
        self.validate_request(request)
        request.enqueue_wall = time.perf_counter()
        self.scheduler.submit(request, tick=self.tick)
        self.events.record("submitted", request.rid, tick=self.tick,
                           wall=request.enqueue_wall)

    # ----------------------------------------------------------- prefill

    def _pack_greedy(self, items, sizes):
        """Greedy bucket split: a batch closes when the next packed
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

    def _packed_call(self, rows):
        """ONE packed prefill call for ``rows = [(slot_idx, prompt)]``:
        segment ids 1..R, padding on segment 0 routed to the all-null
        spare page-table row ``num_slots``, one logits row gathered at
        each prompt's last token. Returns ``(logits [R, vocab], t0)``."""
        S, R = self.prefill_len, self.prefill_requests
        ids = np.zeros((S,), np.int64)
        positions = np.zeros((S,), np.int64)
        seg = np.zeros((S,), np.int32)
        token_rows = np.full((S,), self.num_slots, np.int64)
        gather_idx = np.zeros((R,), np.int64)
        pt = np.zeros((self.num_slots + 1, self.max_pages), np.int32)
        pt[:self.num_slots] = self.scheduler.page_table_rows()
        cursor = 0
        for r, (si, fed) in enumerate(rows):
            n = len(fed)
            ids[cursor:cursor + n] = fed
            positions[cursor:cursor + n] = np.arange(n)
            seg[cursor:cursor + n] = r + 1
            token_rows[cursor:cursor + n] = si
            gather_idx[r] = cursor + n - 1
            cursor += n
        keep = None
        if self.kv_quant:
            # keep_scale row (kv_tier.prefill_scatter_quant): 0 for every
            # page a prefilling row writes (each is freshly granted: with
            # no prefix cache and no verify replay a row writes from
            # position 0, so stale codes there must not pin the scale), 1
            # for every other page, whose content must survive
            keep = np.ones((self.num_pages,), np.float32)
            for si, fed in rows:
                pages = self.scheduler.slots[si].pages
                for j in range((len(fed) - 1) // self.page_size + 1):
                    if j < len(pages):
                        keep[pages[j]] = 0.0
            keep = self._tensor(keep)
        t0 = time.perf_counter()
        self.cache, logits = smodel.prefill(
            self.params, self.cache, self._tensor(ids),
            self._tensor(positions), self._tensor(seg),
            self._tensor(token_rows), self._tensor(pt),
            self._tensor(gather_idx), keep, cfg=self.cfg)
        return logits, t0

    def _sample_first_tokens(self, logits_rows, requests):
        """First tokens from the prefill logits ``[R, vocab]`` (JAX's
        ``_sample_first_tokens``): the fp32 argmax with sampling off, else
        the decode program's lane semantics (counter 0, the request's own
        key), run eagerly between dispatches."""
        if not self.sampling:
            return torch.argmax(logits_rows.float(), dim=-1).cpu().numpy()
        temps, top_ks, top_ps, keys, counters = sampling_mod.batch_lanes(
            requests)
        toks = sampling_mod.sample_tokens(
            logits_rows, self._tensor(temps), self._tensor(top_ks),
            self._tensor(top_ps), self._tensor(keys.astype(np.int64)),
            self._tensor(counters),
            torch.ones(len(requests), dtype=torch.bool, device=self.device))
        return toks.cpu().numpy()

    def _run_prefill(self, slot_indices):
        """Pack the newly admitted slots' prompts into ``[prefill_len]``
        batches, fill the cache, and take each request's first token from
        its last prompt token's logits."""
        sch = self.scheduler
        prompts = [sch.slots[si].request.prompt for si in slot_indices]
        for batch in self._pack_greedy(list(zip(slot_indices, prompts)),
                                       [len(p) for p in prompts]):
            logits, t0 = self._packed_call(batch)
            self.prefill_batches += 1
            next_toks = self._sample_first_tokens(
                logits[:len(batch)], [sch.slots[si].request
                                      for si, _ in batch])
            wall = time.perf_counter()
            self.device_dispatch_s += wall - t0
            for r, (si, prompt) in enumerate(batch):
                slot = sch.slots[si]
                req = slot.request
                slot.pos = len(prompt)
                tok = int(next_toks[r])
                req.out_tokens.append(tok)
                slot.next_token = tok
                self.tokens_generated += 1
                # prefill samples the request's FIRST token: this fetch's
                # wall is the TTFT stamp
                req.first_token_wall = wall
                self.events.record("prefill_done", req.rid, tick=self.tick,
                                   wall=wall)
                self.events.record("first_token", req.rid, tick=self.tick,
                                   wall=wall)
                if req.done():
                    req.finish_wall = wall
                    self.events.record("finished", req.rid, tick=self.tick,
                                       wall=wall)
        return list(slot_indices)

    # ------------------------------------------------------------ decode

    def _init_decode_inputs(self):
        """The decode program's inputs: one int32 buffer on the device
        (``_inputs``; fp32 lanes stored as their bits) with a named view
        per input, and its host twin (pinned on the card), filled each
        round and sent in one copy."""
        B, P, K = self.num_slots, self.max_pages, self.decode_k
        fields = (("tokens", (B,)), ("lengths", (B,)),
                  ("page_table", (B, P)), ("steps", (B,)),
                  ("warm_steps", (B,)), ("warm_tokens", (K, B)),
                  ("temps", (B,)), ("top_ks", (B,)), ("top_ps", (B,)),
                  ("keys", (B, 2)), ("counters", (B,)))
        total = sum(int(np.prod(shape)) for _, shape in fields)
        host = torch.zeros(total, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        self._host_inputs = host
        self._inputs = torch.zeros(total, dtype=torch.int32,
                                   device=self.device)
        flat = host.numpy()
        self._host_views, self._views = {}, {}
        o = 0
        for name, shape in fields:
            n = int(np.prod(shape))
            hv, dv = flat[o:o + n], self._inputs[o:o + n]
            if name in ("temps", "top_ps"):
                hv, dv = hv.view(np.float32), dv.view(torch.float32)
            elif name == "keys":
                hv = hv.view(np.uint32)
            self._host_views[name] = hv.reshape(shape)
            self._views[name] = dv.view(shape)
            o += n

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
        """This block's step budget for one live lane: its remaining new
        tokens, capped at ``decode_k`` (the port has no warm-up steps, so
        JAX's ``warm + rem`` is ``rem``). A lane never decodes past its
        last token inside a block, so block writes stay within the
        request's ``prompt + max_new_tokens`` pages."""
        req = slot.request
        return min(self.decode_k, req.max_new_tokens - len(req.out_tokens))

    def _stage_block(self, decode_lanes):
        """Per-lane staging of one K-block (JAX's ``_stage_block``):
        ``steps`` maps lane -> the steps its bookkeeping consumes; the
        device budget is 0 for a lane that finished at this round's
        prefill (ballast: inactive for the whole block). The warm-token
        feed stays zero."""
        h = self._host_views
        h["steps"][:] = 0
        h["warm_steps"][:] = 0
        h["warm_tokens"][:] = 0
        steps = {}
        for i in decode_lanes:
            slot = self.scheduler.slots[i]
            if slot.request.done():
                steps[i] = 1
                continue
            steps[i] = h["steps"][i] = self._lane_budget(slot)
        return steps

    def _stage_inputs(self, decode_lanes):
        """Fill the host twin with this round's tokens, lengths, page
        table, block budgets and sampling lanes; returns ``steps``."""
        sch = self.scheduler
        h = self._host_views
        tokens, lengths = sch.decode_inputs()
        h["tokens"][:] = tokens
        h["lengths"][:] = lengths
        h["page_table"][:] = sch.page_table_rows()
        if self.decode_k > 1:
            steps = self._stage_block(decode_lanes)
        else:
            steps = {i: 1 for i in decode_lanes}
        if self.sampling:
            for name, arr in zip(LANES, sampling_mod.lane_arrays(
                    sch.slots, self.num_slots)):
                h[name][:] = arr
        return steps

    def _dispatch_decode(self, decode_lanes):
        """Stage and run ONE decode program for the current slots (a
        graph replay, or the eager call); returns ``(next_toks, t0,
        steps)`` with the fetch left to the caller. A graph's output is
        overwritten by the next replay: the caller's fetch copies it out
        first."""
        steps = self._stage_inputs(decode_lanes)
        t0 = time.perf_counter()
        self._inputs.copy_(self._host_inputs, non_blocking=True)
        if self._graph is None:
            return self._decode_program(), t0, steps
        if self._cache_ptrs() != self._graph_cache:
            raise RuntimeError("the KV cache moved since the decode graph "
                               "was captured: its writes must stay in "
                               "place")
        self._graph.replay()
        return self._graph_out, t0, steps

    def _advance_counts(self, decode_lanes, steps):
        """Count bookkeeping of one decode block, walking its (step,
        lane) grid: every consumed step advances the lane's position; a
        lane still short of its token budget gets a placeholder token that
        :meth:`_fill_plan` fills (a lane that finished at this round's
        prefill rides as discarded ballast). Returns ``(plan,
        decoded)``."""
        sch = self.scheduler
        plan = []
        decoded = 0
        for j in range(self.decode_k):
            for i in decode_lanes:
                if j >= steps.get(i, 0):
                    continue
                slot = sch.slots[i]
                req = slot.request
                slot.pos += 1
                if not req.done():
                    req.out_tokens.append(None)   # the value lands at fill
                    self.tokens_generated += 1
                    plan.append({"lane": i, "step": j, "slot": slot,
                                 "req": req,
                                 "out_idx": len(req.out_tokens) - 1,
                                 "done": req.done()})
                decoded += 1
        self.decode_steps += 1
        return plan, decoded

    def _fill_plan(self, plan, next_toks, wall, tick):
        """The value half of the round bookkeeping: fill the placeholder
        tokens (``next_toks`` ``[B]``, or ``[K, B]`` from a block, indexed
        by (step, lane)) and stamp the finish walls and events. A lane
        with several tokens in a block fills in step order, so its
        ``next_token`` is the last step's."""
        toks = np.asarray(next_toks)
        if toks.ndim == 1:
            toks = toks[None]
        for e in plan:
            tok = int(toks[e["step"], e["lane"]])
            e["req"].out_tokens[e["out_idx"]] = tok
            e["slot"].next_token = tok
            if e["done"]:
                e["req"].finish_wall = wall
                self.events.record("finished", e["req"].rid, tick=tick,
                                   wall=wall)

    # ------------------------------------------------------------- rounds

    def step(self, arrivals=None):
        """One scheduler round: enqueue due arrivals, evict, admit +
        prefill, decode every occupied slot. Returns a dict of what
        happened."""
        now = self.tick
        for req in arrivals or ():
            self.submit(req)
        sch = self.scheduler
        wall = time.perf_counter()
        evicted = sch.evict_done(now, wall)
        admitted = sch.admit(now, wall)
        for r in evicted:
            self.events.record("evicted", r.rid, tick=now, wall=wall)
        for i in admitted:
            self.events.record("admitted", sch.slots[i].request.rid,
                               tick=now, wall=wall)
        prefilled = self._run_prefill(admitted) if admitted else []
        decode_lanes = sch.active_indices()
        decoded = 0
        if decode_lanes:
            next_toks, t0, steps = self._dispatch_decode(decode_lanes)
            plan, decoded = self._advance_counts(decode_lanes, steps)
            next_toks = next_toks.cpu().numpy()
            wall2 = time.perf_counter()
            self.device_dispatch_s += wall2 - t0
            self._fill_plan(plan, next_toks, wall2, now)
        # a slot whose LAST token was just produced frees at the next
        # round's evict
        self.tick += 1
        return {"tick": now, "evicted": [r.rid for r in evicted],
                "admitted": admitted, "prefilled": prefilled,
                "decoded_slots": decoded}

    def run_trace(self, requests, max_ticks=10000):
        """Replay a trace to completion: each request is submitted when
        its arrival tick is due; returns the completed requests (latency
        stamps filled)."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        trace_ids = {id(r) for r in requests}

        def settled():
            return sum(id(r) in trace_ids for r in self.scheduler.completed)

        while settled() < len(requests):
            if self.tick >= max_ticks:
                raise RuntimeError(
                    f"trace did not drain in {max_ticks} ticks "
                    f"({settled()}/{len(requests)} settled)")
            due = [r for r in pending if r.arrival <= self.tick]
            pending = [r for r in pending if r.arrival > self.tick]
            self.step(arrivals=due)
        return list(self.scheduler.completed)
