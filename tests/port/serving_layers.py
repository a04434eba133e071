"""Shared harness of the serving-layer parity tests
(``test_torch_serving_generation.py``, ``test_torch_serving_resilience.py``):
the JAX engine and the port's serve the same seeded trace on one set of
weights (the JAX GPTModel init, carried across by ``from_jax_params``),
fp32, under one fake clock, and every observable is compared.

The clock: both engines read ``time.perf_counter`` for their wall stamps,
and the deadline shedder and the head-of-line gauge act on them, so each
engine module's ``time`` is replaced by a :class:`Clock` that the driving
loop sets to ``tick * tick_s`` before every round. Both engines then see
the same walls at the same ticks, and the comparison can include the
shedder's decisions, the gauges and the event walls.
"""

import jax
import numpy as np

from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import engine as jengine_mod
from apex_tpu.serving import lifecycle as jlife
from apex_tpu.serving import model as jmodel
from apex_tpu.serving import scheduler as jsched
from apex_tpu.serving.sampling import SamplingParams as JSampling
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import engine as tengine_mod
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.serving.sampling import SamplingParams as TSampling
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

# the JAX serving tests' small model (2 layers, hidden 64, 4 heads)
KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=256, max_position_embeddings=64, hidden_dropout=0.0,
          attention_dropout=0.0, apply_query_key_layer_scaling=False)
PS = 8
ENGINE = dict(num_slots=3, page_size=PS, num_pages=24, max_seq=64,
              prefill_len=32)
# short prompts, generations long enough to loop (the n-gram drafts hit)
TRACE = dict(seed=3, n_requests=10, vocab=256, prompt_lo=3, prompt_hi=14,
             new_lo=6, new_hi=20)
# generations that outgrow a small pool (KV-pressure preemption)
LONG = dict(seed=4, n_requests=8, vocab=256, prompt_lo=3, prompt_hi=14,
            new_lo=20, new_hi=40, mean_interarrival=0.3)
# a 12-token system prompt: one full page and a 4-token tail at pages of 8
SYSTEM = [int(t) for t in np.random.RandomState(1).randint(0, 256, 12)]
SYSTEM_TRACE = dict(TRACE, system_prompt=SYSTEM, prompt_lo=1, prompt_hi=10)
TICK_S = 0.1


class Clock:
    """A ``time`` stand-in whose ``perf_counter`` the driving loop sets."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, _s):
        pass


def jax_tree():
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_gpt_params(JConfig(**KW)))


def trace(sched, spec, sampled=False):
    """The seeded trace for one package; with ``sampled`` every third
    request samples (temperature 0.8, top-k 20, top-p 0.95) and every
    third plus one at temperature 1.5."""
    reqs, _ = sched.synthetic_trace(**spec)
    if sampled:
        cls = JSampling if sched is jsched else TSampling
        for r in reqs:
            if r.rid % 3 == 1:
                r.sampling = cls(temperature=0.8, top_k=20, top_p=0.95,
                                 seed=r.rid)
            elif r.rid % 3 == 2:
                r.sampling = cls(temperature=1.5, seed=1000 + r.rid)
    return reqs


def serve(engine, reqs, clock, tick_s=TICK_S, burst=None):
    """Drive ``engine`` round by round until every request of ``reqs``
    settled (completed, rejected or shed), the clock at ``tick * tick_s``
    through each round; ``burst`` requests are submitted at once before
    the first round."""
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    ids = {id(r) for r in reqs} | {id(r) for r in burst or ()}
    sch = engine.scheduler
    clock.now = engine.tick * tick_s
    for r in burst or ():
        engine.submit(r)

    def settled():
        return sum(id(r) in ids for r in
                   list(sch.completed) + [r for r, _ in engine.rejected]
                   + list(sch.shed))

    while settled() < len(ids):
        assert engine.tick < 3000, "the trace did not drain"
        clock.now = engine.tick * tick_s
        due = [r for r in pending if r.arrival <= engine.tick]
        pending = [r for r in pending if r.arrival > engine.tick]
        engine.step(arrivals=due)
    engine.flush()   # the overlapped round's tokens in flight land
    return record(engine, list(reqs) + list(burst or ()))


def record(engine, reqs):
    """Every observable of a served engine: tokens and ticks by request,
    the counters, the rate accounts, the event log and the gauges."""
    sch = engine.scheduler
    return {
        "requests": {r.rid: (list(r.out_tokens), r.admitted_tick,
                             r.finished_tick, r.preemptions, r.shed_tick,
                             r.first_token_wall, r.finish_wall)
                     for r in reqs},
        "counters": (engine.tick, engine.prefill_batches,
                     engine.decode_steps, engine.verify_calls,
                     engine.tokens_generated),
        "generation": engine.generation_stats(),
        "resilience": engine.resilience_rates(),
        "resilience_counts": (engine.resilience.rejected,
                              engine.resilience.shed,
                              engine.resilience.preempted,
                              engine.resilience.resubmitted,
                              engine.resilience.submit_attempts,
                              engine.resilience.admissions),
        "kv_tier": engine.kv_tier_rates(),
        "kv_stats": None if engine.kv_stats is None else (
            engine.kv_stats.swap_outs, engine.kv_stats.swap_ins,
            engine.kv_stats.restores_swap,
            engine.kv_stats.restores_recompute,
            engine.kv_stats.swapped_pages_live),
        "spec": None if engine.spec_stats is None else (
            engine.spec_stats.rounds, engine.spec_stats.drafted,
            engine.spec_stats.accepted),
        "prefix": None if engine.prefix is None else (
            engine.prefix.hit_tokens, engine.prefix.lookup_tokens,
            len(engine.prefix.nodes), len(engine.prefix.tails),
            sorted(engine.prefix.refs.items())),
        "rejected": [(r.rid, x.reason, x.retry_after_ticks)
                     for r, x in engine.rejected],
        "shed": [r.rid for r in sch.shed],
        "completed": [r.rid for r in sch.completed],
        "events": [(e["event"], e["rid"], e["tick"], e["wall"])
                   for e in engine.events.events],
        "gauges": engine.events.gauges,
        "free_pages": engine.allocator.free_count,
    }


def engines(jtree, monkeypatch, **kw):
    """The JAX engine (lifecycle collection on) and the port's (on the
    CPU), both built with ``ENGINE`` updated by ``kw``, and the clock both
    modules now read."""
    clock = Clock()
    monkeypatch.setattr(jengine_mod, "time", clock)
    monkeypatch.setattr(tengine_mod, "time", clock)
    spec = dict(ENGINE, **kw)
    jlife.enable()
    try:
        je = JEngine(JConfig(**KW), jtree, **spec)
    finally:
        jlife.reset_enabled()
    tcfg = TConfig(**KW)
    te = TEngine(tcfg, tweights.from_jax_params(jtree, tcfg, "cpu"),
                 device="cpu", **spec)
    return je, te, clock


def parity(jtree, monkeypatch, trace_spec, sampled=False, burst=None,
           **kw):
    """Serve ``trace_spec`` through both engines built with ``kw`` and
    assert every observable equal; returns the port's engine and record.
    ``burst(sched)`` builds requests submitted before the first round."""
    je, te, clock = engines(jtree, monkeypatch, **kw)
    want = serve(je, trace(jsched, trace_spec, sampled), clock,
                 burst=burst(jsched) if burst else None)
    got = serve(te, trace(tsched, trace_spec, sampled), clock,
                burst=burst(tsched) if burst else None)
    for key in want:
        assert got[key] == want[key], key
    assert te.events.validate_order() == []
    te.allocator.check_invariants()
    if te.prefix is not None:
        te.prefix.check_invariants()
    return te, got
