"""ServingEngine: cache + parameters + scheduler in one object
(counterpart of ``apex_tpu/serving/engine.py``, the serial greedy round).

All host work (admission, eviction, page accounting, array staging)
happens between device calls. One scheduler round (:meth:`step`): submit
due arrivals, evict finished requests, admit what fits, prefill the
admitted prompts in packed ``[prefill_len]`` batches (the prefill
attention kernel), then one decode step for every occupied slot (the
decode attention kernel). The cache and operand shapes are fixed at
construction; scheduler events change values only.

Greedy decoding only: a request whose ``sampling`` is not greedy raises
at :meth:`submit`, as on the JAX engine built without sampling.
``kv_quant=True`` (or ``APEX_SERVE_KV_QUANT=1`` when the argument is
None) serves over the int8 KV tier (:mod:`~apex_tpu_torch.serving.
kv_tier`): int8 codes with per-(page, head) bf16 scales, quantized at
write, read by K2q. The JAX engine's other layers — sampling,
speculative decode, the prefix cache, the overlapped round, admission
control, shedding, preemption, round recovery, the host swap tier,
tensor parallelism and multi-token decode blocks — are later slices
(ROADMAP.md); ``kv_swap=True`` and ``kv_restore="swap"`` raise, as the
JAX engine raises on them without preemption. This engine runs the JAX
engine's configuration with those layers off, token for token.

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
from apex_tpu_torch.serving.kv_cache import PageAllocator, init_cache
from apex_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from apex_tpu_torch.serving.weights import init_gpt_params


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to_device(v, device) for k, v in tree.items()}


class ServingEngine:
    def __init__(self, cfg, params=None, *, num_slots=4, page_size=16,
                 num_pages=64, max_seq=None, prefill_len=64,
                 prefill_requests=None, policy=None, seed=0, device=None,
                 kv_quant=None, kv_swap=None, kv_restore=None):
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
        prefill bucket, or a non-greedy sampling demand."""
        self.scheduler.validate(request)
        if len(request.prompt) > self.prefill_len:
            raise ValueError(
                f"request {request.rid}: prompt ({len(request.prompt)} "
                f"tokens) exceeds prefill_len={self.prefill_len}")
        sp = request.sampling
        if sp is not None and not getattr(sp, "greedy", False):
            raise ValueError(
                f"request {request.rid} demands stochastic sampling but "
                f"this engine decodes greedily (sampling is not ported)")

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

    def _run_prefill(self, slot_indices):
        """Pack the newly admitted slots' prompts into ``[prefill_len]``
        batches, fill the cache, and take each request's first token
        (greedy) from its last prompt token's logits."""
        sch = self.scheduler
        prompts = [sch.slots[si].request.prompt for si in slot_indices]
        for batch in self._pack_greedy(list(zip(slot_indices, prompts)),
                                       [len(p) for p in prompts]):
            logits, t0 = self._packed_call(batch)
            self.prefill_batches += 1
            next_toks = torch.argmax(logits[:len(batch)].float(),
                                     dim=-1).cpu().numpy()
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

    def _dispatch_decode(self):
        """Stage and run ONE decode step for the current slots; returns
        ``(next_toks, t0)`` with the fetch left to the caller."""
        sch = self.scheduler
        tokens, lengths = sch.decode_inputs()
        pt = np.asarray(sch.page_table_rows(), np.int32)
        t0 = time.perf_counter()
        self.cache, next_toks, _ = smodel.decode_step(
            self.params, self.cache, self._tensor(np.asarray(tokens)),
            self._tensor(np.asarray(lengths)), self._tensor(pt),
            cfg=self.cfg)
        return next_toks, t0

    def _advance_counts(self, decode_lanes):
        """Count bookkeeping of one decode step: every lane's position
        advances; a lane still short of its token budget gets a
        placeholder token that :meth:`_fill_plan` fills (a lane that
        finished at this round's prefill rides the step as discarded
        ballast). Returns ``(plan, decoded)``."""
        sch = self.scheduler
        plan = []
        for i in decode_lanes:
            slot = sch.slots[i]
            req = slot.request
            slot.pos += 1
            if not req.done():
                req.out_tokens.append(None)   # the value lands at fill
                self.tokens_generated += 1
                plan.append({"lane": i, "slot": slot, "req": req,
                             "out_idx": len(req.out_tokens) - 1,
                             "done": req.done()})
        self.decode_steps += 1
        return plan, len(decode_lanes)

    def _fill_plan(self, plan, next_toks, wall, tick):
        """The value half of the round bookkeeping: fill the placeholder
        tokens and stamp the finish walls and events."""
        for e in plan:
            tok = int(next_toks[e["lane"]])
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
            next_toks, t0 = self._dispatch_decode()
            plan, decoded = self._advance_counts(decode_lanes)
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
