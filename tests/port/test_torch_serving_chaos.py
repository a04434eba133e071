"""Port parity of serving's recovery layers and the overlapped round:
``apex_tpu_torch.serving`` against ``apex_tpu.serving`` under the same
``APEX_FAULT_PLAN`` (the cases of ``tests/test_serving_chaos.py``).

Both engines serve one request list on one set of weights (fp32,
``from_jax_params``) under one fake clock (``serving_layers.py``), each
under the same fault plan, and every observable is compared: each
``step()`` result (its ``degraded`` entry included), the tokens and the
ticks they arrive at, the counters, ``resilience_rates()`` and
``kv_tier_rates()``, the event logs and the gauges:

* a decode dispatch that hangs past the watchdog (``wedged``), one that
  raises (``degraded_relay``), a prefill that raises mid-admission, the
  attempt budget raising, the engine dying without the watchdog;
  recovery skipping a slot that finished in the failed round, with and
  without its prefix references; every layer at once under pressure and
  a hang; the scripted page-grant refusal; the burst against admission
  control; the swap tier's copy failing (a raise or a hang at swap-out, a
  corrupted handle at swap-in) and falling back to recompute;
* the port's abandoned dispatch launches nothing once it wakes: the
  engine's epoch moved (``stale_dispatches``), no closure launched after
  the recovery, and the decode program still replays its tokens;
* the overlapped round against JAX's overlapped engine and against the
  port's serial one (the same tokens, admissions and evictions by tick),
  greedy, sampled, with the prefix cache, at ``decode_k=4`` and over the
  int8 KV tier; the shedder composed with it; and ``slo_block`` against
  JAX's on the same served requests and gauges.

The watchdog's timeout in the hang cases (``TIMEOUT_S``) sits far above a
clean dispatch of this model on the CPU (milliseconds) and far below an
injected hang (``HANG_S``); both engines compile and warm up under a
generous budget before it is set.
"""

import json

import numpy as np
import pytest
import torch

from apex_tpu.resilience import faults as jfaults
from apex_tpu.serving import lifecycle as jlife
from apex_tpu.serving import scheduler as jsched
from apex_tpu_torch.resilience import faults as tfaults
from apex_tpu_torch.serving import lifecycle as tlife
from apex_tpu_torch.serving import scheduler as tsched

import serving_layers as sl

torch.set_num_threads(2)

TIMEOUT_S = 0.5      # the watchdog once warm
HANG_S = 2.0         # an injected hang
WARM_TIMEOUT_S = 120.0
SMALL = 10           # pages: KV pressure at sl.LONG


@pytest.fixture(scope="module")
def jax_tree():
    return sl.jax_tree()


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch):
    monkeypatch.delenv("APEX_FAULT_PLAN", raising=False)
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}
    yield
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}


def _requests(sched, spec):
    """``[(prompt_len, max_new, arrival)]`` as requests, prompts drawn from
    one seed."""
    rs = np.random.RandomState(11)
    return [sched.Request(rid=i, prompt=[int(t) for t in rs.randint(
        0, 256, n)], max_new_tokens=new, arrival=float(at))
        for i, (n, new, at) in enumerate(spec)]


# three slots: three requests at tick 0, two more at tick 4
BASIC = [(6, 10, 0), (9, 12, 0), (5, 8, 0), (7, 6, 4), (12, 9, 4)]


def _serve(engine, reqs, clock, monkeypatch, plan=None, warm=0,
           timeout=None, max_ticks=400):
    """Drive ``engine`` round by round until every request settled: the
    plan (and, for the watchdog, ``timeout``) set after ``warm`` rounds,
    each round under the clock at ``tick * TICK_S``. Returns the step
    results and ``serving_layers.record``."""
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}
    monkeypatch.delenv("APEX_FAULT_PLAN", raising=False)
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    ids = {id(r) for r in reqs}
    sch = engine.scheduler
    results = []

    def settled():
        return sum(id(r) in ids for r in
                   list(sch.completed) + [r for r, _ in engine.rejected]
                   + list(sch.shed))

    while settled() < len(reqs):
        assert engine.tick < max_ticks, "the requests did not drain"
        if engine.tick == warm and plan is not None:
            monkeypatch.setenv("APEX_FAULT_PLAN", json.dumps(plan))
            if timeout is not None:
                engine.dispatch_timeout_s = timeout
        clock.now = engine.tick * sl.TICK_S
        due = [r for r in pending if r.arrival <= engine.tick]
        pending = [r for r in pending if r.arrival > engine.tick]
        results.append(engine.step(arrivals=due))
    engine.flush()
    monkeypatch.delenv("APEX_FAULT_PLAN", raising=False)
    rec = sl.record(engine, reqs)
    rec["results"] = results
    rec["recovery"] = (engine.resilience.degraded_rounds,
                       engine.resilience.last_verdict)
    rec["swap_failures"] = None if engine.kv_stats is None else (
        engine.kv_stats.swap_out_failures, engine.kv_stats.swap_in_failures)
    return rec


def _parity(jax_tree, monkeypatch, spec, plan=None, warm=0, timeout=None,
            **kw):
    """Both engines built with ``kw`` serve ``spec`` under ``plan``; every
    observable equal. Returns the port's engine and record."""
    je, te, clock = sl.engines(jax_tree, monkeypatch, **kw)
    want = _serve(je, _requests(jsched, spec), clock, monkeypatch, plan,
                  warm, timeout)
    got = _serve(te, _requests(tsched, spec), clock, monkeypatch, plan,
                 warm, timeout)
    for key in want:
        assert got[key] == want[key], key
    assert te.events.validate_order() == []
    te.allocator.check_invariants()
    if te.prefix is not None:
        te.prefix.check_invariants()
    return te, got


def _recover_kw(**kw):
    return dict(recover=True, dispatch_timeout_s=WARM_TIMEOUT_S,
                round_retry_wait_s=0, **kw)


def _degraded(rec):
    return [r["degraded"] for r in rec["results"] if r.get("degraded")]


def _hang(site, tick, **extra):
    return [{"site": site, "kind": "hang", "seconds": HANG_S,
             "match_ctx": dict(tick=tick, **extra)}]


def _raise(site, message, **ctx):
    return [{"site": site, "kind": "raise", "message": message,
             "match_ctx": ctx}]


# ----------------------------------------------------- round recovery

def test_decode_hang_timed_out_classified_and_recovered(jax_tree,
                                                        monkeypatch):
    """A decode dispatch that hangs is timed out, classified ``wedged``,
    every unfinished request requeued with ``degraded_round``, and the
    engine finishes everything with JAX's tokens. The port's abandoned
    closure, woken, finds a new epoch and launches nothing; the decode
    program still replays, into the same cache tensors."""
    te, got = _parity(jax_tree, monkeypatch, BASIC,
                      _hang("serve_decode", 2), warm=2, timeout=TIMEOUT_S,
                      **_recover_kw())
    deg = _degraded(got)
    assert [(d["phase"], d["verdict"]) for d in deg] == [("decode",
                                                         "wedged")]
    assert got["recovery"] == (1, "wedged")
    assert got["resilience"]["degraded_rounds"] == 1
    rid = deg[0]["requeued"][0]
    chain = [e["event"] for e in te.events.request_events(rid)]
    i = chain.index("degraded_round")
    assert chain[i + 1] == "resubmitted"
    launched = te.dispatches
    assert len(te.abandoned_workers) == 1
    te.abandoned_workers[0].join(timeout=30)
    assert not te.abandoned_workers[0].is_alive()
    assert (te.stale_dispatches, te.dispatches, te.epoch) == (1, launched,
                                                              1)
    # the engine keeps serving after the stale wake, from the same cache
    ptrs = [t.data_ptr() for t in te.cache.values()]
    done = te.run_trace([tsched.Request(rid=50, prompt=[3, 1, 4, 1, 5],
                                        max_new_tokens=4,
                                        arrival=float(te.tick))])
    assert len(done[-1].out_tokens) == 4
    assert [t.data_ptr() for t in te.cache.values()] == ptrs


def test_decode_exception_classified_degraded_relay(jax_tree, monkeypatch):
    _, got = _parity(jax_tree, monkeypatch, BASIC,
                     _raise("serve_decode", "relay reset by peer", tick=2),
                     **_recover_kw())
    assert got["recovery"] == (1, "degraded_relay")
    assert [d["detail"] for d in _degraded(got)] == [
        "RuntimeError: relay reset by peer"]


def test_prefill_failure_mid_admission_recovered(jax_tree, monkeypatch):
    """The tick-4 admission's prefill raises: the admitted requests (and
    the running ones) requeue and replay; JAX's tokens."""
    spec = [(6, 3, 0), (9, 3, 0), (5, 3, 0), (7, 6, 4), (12, 9, 4)]
    _, got = _parity(jax_tree, monkeypatch, spec,
                     _raise("serve_prefill", "compile helper 500", tick=4),
                     **_recover_kw())
    deg = _degraded(got)
    assert [(d["phase"], d["verdict"]) for d in deg] == [
        ("prefill", "degraded_relay")]
    assert sorted(deg[0]["requeued"]) == [3, 4]


def test_round_attempt_budget_exhausts_loudly(jax_tree, monkeypatch):
    """A dispatch that fails every round exhausts ``round_attempts`` and
    raises, in both engines, after the same degraded rounds."""
    je, te, clock = sl.engines(jax_tree, monkeypatch, recover=True,
                               dispatch_timeout_s=WARM_TIMEOUT_S,
                               round_attempts=2, round_retry_wait_s=0)
    monkeypatch.setenv("APEX_FAULT_PLAN", json.dumps(
        _raise("serve_prefill", "device is gone")))
    for eng, sched in ((je, jsched), (te, tsched)):
        eng.submit(sched.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
        with pytest.raises(RuntimeError, match="budget is exhausted"):
            for _ in range(10):
                eng.step()
    assert je.resilience.degraded_rounds == te.resilience.degraded_rounds \
        == 2
    assert [(e["event"], e["rid"], e["tick"]) for e in te.events.events] \
        == [(e["event"], e["rid"], e["tick"]) for e in je.events.events]


def test_without_watchdog_the_engine_dies(jax_tree, monkeypatch):
    je, te, _ = sl.engines(jax_tree, monkeypatch)
    assert not je.recover and not te.recover
    monkeypatch.setenv("APEX_FAULT_PLAN", json.dumps(
        _raise("serve_decode", "relay reset by peer", tick=0)))
    for eng, sched in ((je, jsched), (te, tsched)):
        eng.submit(sched.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
        with pytest.raises(RuntimeError, match="relay reset"):
            eng.step()


@pytest.mark.parametrize("released", [True, False],
                         ids=["released", "wedged"])
def test_hang_inside_a_launch_recovers_or_raises(jax_tree, monkeypatch,
                                                 released):
    """The tick-4 admission's prefill hangs inside its launch, holding the
    engine lock, where a launch that waits on the device would. The
    watchdog times the dispatch out. Released then, the launch ends,
    recovery takes the lock, and the engine serves every request with the
    fault-free run's tokens; never released, taking the lock back runs out
    of the dispatch budget and the engine raises, naming the wedge,
    instead of waiting for ever. (No fault plan reaches inside a launch,
    so the port's engine is held to its own fault-free run.)"""
    import itertools
    import threading

    from apex_tpu_torch.serving import ServingEngine
    from apex_tpu_torch.serving import model as tmodel
    from apex_tpu_torch.serving import resilience as tres
    from apex_tpu_torch.serving import weights as tweights
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**sl.KW)
    params = tweights.from_jax_params(jax_tree, cfg, "cpu")

    def serve(engine):
        reqs = _requests(tsched, BASIC)
        engine.run_trace(reqs)
        return {r.rid: list(r.out_tokens) for r in reqs}

    kw = dict(sl.ENGINE, **_recover_kw())
    want = serve(ServingEngine(cfg, params, device="cpu", **kw))
    te = ServingEngine(cfg, params, device="cpu", **kw)
    te.dispatch_timeout_s = HANG_S if released else TIMEOUT_S
    gate = threading.Event()
    real, calls = tmodel.prefill, itertools.count()

    def prefill(*args, **kwargs):
        if next(calls) == 1:          # the tick-4 admission
            gate.wait(60)
        return real(*args, **kwargs)

    run = te._watchdog.run

    def watched(fn, timeout_s, phase):
        try:
            return run(fn, timeout_s, phase)
        except tres.DispatchFailure:
            if released:
                gate.set()
            raise

    monkeypatch.setattr(tmodel, "prefill", prefill)
    monkeypatch.setattr(te._watchdog, "run", watched)
    try:
        if released:
            assert serve(te) == want
        else:
            with pytest.raises(RuntimeError, match="dispatch budget"):
                serve(te)
    finally:
        gate.set()
        for w in te.abandoned_workers:
            w.join(timeout=30)
            assert not w.is_alive()
    assert len(te.abandoned_workers) == 1
    assert te.resilience.last_verdict == "wedged"
    if released:
        assert (te.resilience.degraded_rounds, te.epoch) == (1, 1)
        assert te.events.validate_order() == []
        te.allocator.check_invariants()


@pytest.mark.parametrize("prefix", [False, True])
def test_recovery_skips_finished_slots(jax_tree, monkeypatch, prefix):
    """A request that finishes at the failed round's own prefill (one
    token) is not requeued; with the prefix cache it holds shared pages
    (a full page of prompt, registered at that prefill), whose
    references recovery releases before flushing the cache."""
    spec = [(6, 10, 0), (9, 10, 0), (sl.PS + 1, 1, 2)]
    plan = (_hang("serve_decode", 2) if not prefix
            else _raise("serve_decode", "relay reset", tick=2))
    te, got = _parity(jax_tree, monkeypatch, spec, plan, warm=2,
                      timeout=TIMEOUT_S,
                      **_recover_kw(prefix_cache=prefix))
    assert got["recovery"][0] == 1
    chain = [e["event"] for e in te.events.request_events(2)]
    assert "degraded_round" not in chain and "finished" in chain
    assert 2 not in _degraded(got)[0]["requeued"]
    for w in te.abandoned_workers:
        w.join(timeout=30)


def test_all_layers_under_pressure_and_chaos(jax_tree, monkeypatch):
    """Admission control, shedding, preemption and recovery at once: a
    burst into a bounded queue at tick 3, a pool decode outgrows, and a
    decode hang at tick 5."""
    spec = [(6, 30, 0), (9, 28, 0), (5, 26, 0), (7, 20, 1)]
    plan = [{"site": "serve_burst", "kind": "burst", "count": 6,
             "prompt_len": 3, "max_new": 3, "match_ctx": {"tick": 3}},
            {"site": "serve_decode", "kind": "hang", "seconds": HANG_S,
             "match_ctx": {"tick": 5}}]
    te, got = _parity(jax_tree, monkeypatch, spec, plan, warm=2,
                      timeout=TIMEOUT_S,
                      **_recover_kw(num_pages=SMALL, admit=4, shed=True,
                                    shed_ttft_ms=2000.0, preempt=True))
    assert got["recovery"][0] >= 1
    assert got["resilience_counts"][0] > 0     # the burst was rejected
    assert got["resilience_counts"][2] > 0     # and decode preempted
    for w in te.abandoned_workers:
        w.join(timeout=30)


def test_scripted_alloc_deny_preempts(jax_tree, monkeypatch):
    """One refused page grant (``serve_alloc``, phase ``grow``) in a roomy
    pool preempts once, and the stream replays to JAX's tokens."""
    plan = [{"site": "serve_alloc", "kind": "deny", "times": 1,
             "match_ctx": {"phase": "grow"}}]
    spec = [(6, 20, 0), (9, 20, 0), (5, 12, 1)]
    _, got = _parity(jax_tree, monkeypatch, spec, plan, preempt=True)
    assert got["resilience_counts"][2] == 1


def test_serve_burst_rejected_at_the_front_door(jax_tree, monkeypatch):
    plan = [{"site": "serve_burst", "kind": "burst", "count": 12,
             "prompt_len": 3, "max_new": 4, "match_ctx": {"tick": 1}}]
    te, got = _parity(jax_tree, monkeypatch, BASIC, plan, admit=3)
    assert got["resilience_counts"][0] > 0
    assert got["results"]   # the storm's rejections were returned, not
    for _, rej in te.rejected:           # raised
        assert rej.reason == "queue_full" and rej.retry_after_ticks >= 1


SWAP_PLANS = {
    "swap_out_raise": [{"site": "serve_swap", "kind": "raise",
                        "match_ctx": {"phase": "swap_out"}}],
    "swap_out_hang": [{"site": "serve_swap", "kind": "hang",
                       "seconds": 0.05, "match_ctx": {"phase": "swap_out"}}],
    "swap_in_corrupt": [{"site": "serve_swap", "kind": "corrupt",
                         "times": 1, "match_ctx": {"phase": "swap_in"}}],
}


@pytest.mark.parametrize("case", sorted(SWAP_PLANS))
def test_swap_failure_falls_back_to_recompute(jax_tree, monkeypatch, case):
    """The swap tier's copy fails: the stream replays by recompute with a
    ``swap_failed`` event (after ``preempted`` at swap-out, after
    ``admitted`` at swap-in), the same tokens as JAX's, the handle
    released. A bounded hang only delays the copy."""
    je, te, clock = sl.engines(jax_tree, monkeypatch, preempt=True,
                               kv_swap=True, num_pages=SMALL)
    monkeypatch.setenv("APEX_FAULT_PLAN", json.dumps(SWAP_PLANS[case]))
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}
    want = sl.serve(je, sl.trace(jsched, sl.LONG), clock)
    got = sl.serve(te, sl.trace(tsched, sl.LONG), clock)
    for key in want:
        assert got[key] == want[key], key
    assert te.events.validate_order() == []
    st = te.kv_stats
    assert (st.swap_out_failures, st.swap_in_failures) == (
        je.kv_stats.swap_out_failures, je.kv_stats.swap_in_failures)
    assert st.swapped_pages_live == 0
    failed = [e for e in te.events.events if e["event"] == "swap_failed"]
    if case == "swap_out_hang":
        assert not failed and st.swap_out_failures == 0
    else:
        assert failed and (st.swap_out_failures or st.swap_in_failures)
    te.allocator.check_invariants()


# --------------------------------------------------- the overlapped round

OVERLAP_CASES = {
    "greedy": (sl.TRACE, False, {}),
    "sampled": (sl.TRACE, True, dict(sampling=True)),
    "prefix": (sl.SYSTEM_TRACE, False, dict(prefix_cache=True)),
    "decode_k4": (sl.TRACE, False, dict(decode_k=4)),
    "int8_kv": (sl.TRACE, False, dict(kv_quant=True)),
}


def _chains(rec):
    """Each request's (event, tick) chain, walls left out."""
    out = {}
    for ev, rid, tick, _ in rec["events"]:
        out.setdefault(rid, []).append((ev, tick))
    return out


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_overlapped_round_matches_jax_and_the_serial_round(
        jax_tree, monkeypatch, case):
    """The overlapped round against JAX's overlapped engine (every
    observable), and against the port's serial round: the same tokens,
    admission and finish ticks, and each request's events at the same
    ticks (only the host schedule, and so the walls, move)."""
    spec, sampled, kw = OVERLAP_CASES[case]
    te, got = sl.parity(jax_tree, monkeypatch, spec, sampled=sampled,
                        overlap=True, **kw)
    assert te.overlap and te._pending is None
    _, serial, clock = sl.engines(jax_tree, monkeypatch, **kw)
    base = sl.serve(serial, sl.trace(tsched, spec, sampled), clock)
    assert {rid: r[:5] for rid, r in got["requests"].items()} \
        == {rid: r[:5] for rid, r in base["requests"].items()}
    assert _chains(got) == _chains(base)
    assert got["counters"] == base["counters"]


def test_shed_composes_with_overlap(jax_tree, monkeypatch):
    """The shedder runs in the overlapped round too (it touches queued
    requests only), as JAX's does."""
    spec = [(5, 12, 0), (6, 12, 0), (7, 12, 0), (4, 12, 0)]
    _, got = _parity(jax_tree, monkeypatch, spec, num_slots=1, overlap=True,
                     shed=True, shed_ttft_ms=150.0)
    assert got["shed"]


def test_overlap_flush_fills_placeholders(jax_tree, monkeypatch):
    """A caller driving ``step`` sees a placeholder for the round in
    flight until ``flush``, as in JAX's engine."""
    je, te, clock = sl.engines(jax_tree, monkeypatch, overlap=True)
    outs = []
    for eng, sched in ((je, jsched), (te, tsched)):
        req = sched.Request(rid=0, prompt=[1, 2, 3, 4], max_new_tokens=5)
        eng.submit(req)
        eng.step()
        eng.step()
        assert req.out_tokens[-1] is None
        eng.flush()
        assert None not in req.out_tokens
        outs.append(list(req.out_tokens))
    assert outs[0] == outs[1]


def test_slo_block_matches_jax(jax_tree, monkeypatch):
    """``slo_block`` over the same served requests, gauges and resilience
    rates gives JAX's block."""
    je, te, clock = sl.engines(jax_tree, monkeypatch, shed=True,
                               preempt=True, num_pages=SMALL, recover=True,
                               round_retry_wait_s=0)
    jreqs, treqs = sl.trace(jsched, sl.LONG), sl.trace(tsched, sl.LONG)
    sl.serve(je, jreqs, clock)
    sl.serve(te, treqs, clock)
    blocks = []
    for life, eng, reqs in ((jlife, je, jreqs), (tlife, te, treqs)):
        blocks.append(life.slo_block(
            [r for r in reqs if r.done()], eng.tick * sl.TICK_S,
            ttft_ms=400.0, tpot_ms=150.0, arrival_process="poisson",
            offered_load=1.7, log=eng.events,
            resilience=eng.resilience_rates(), decode_block_k=1))
    assert blocks[0] == blocks[1]
    assert blocks[1]["degraded_rounds"] == 0 and blocks[1]["requests"]
    assert tlife.slo_block([], 0.0, ttft_ms=1, tpot_ms=1,
                           arrival_process="poisson", offered_load=0.0) \
        == jlife.slo_block([], 0.0, ttft_ms=1, tpot_ms=1,
                           arrival_process="poisson", offered_load=0.0)


@pytest.mark.parametrize("reuse", [False, True], ids=["thread", "watchdog"])
def test_guarded_dispatch_classifies_as_jax(reuse):
    """JAX's ``guarded_dispatch`` and the port's (a thread a call, and the
    engine's reused ``Watchdog``) give the same result, and the same
    verdict and detail for a call that raises and one that outlives its
    budget; a reused watchdog's abandoned worker leaves once its call
    returns, and the next call gets a new one."""
    import time

    from apex_tpu.serving import resilience as jres
    from apex_tpu_torch.serving import resilience as tres

    watchdog = tres.Watchdog()
    run = watchdog.run if reuse else tres.guarded_dispatch

    def boom():
        raise RuntimeError("relay reset")

    def slow():
        time.sleep(1.0)

    for fn in (lambda: 7, boom, slow):
        outcomes = []
        for guard, failure in ((jres.guarded_dispatch, jres.DispatchFailure),
                               (run, tres.DispatchFailure)):
            try:
                outcomes.append(("ok", guard(fn, 0.2, "decode")))
            except failure as f:
                outcomes.append((f.phase, f.verdict, f.detail))
                if getattr(f, "worker", None) is not None:
                    f.worker.join(timeout=10)
                    assert not f.worker.is_alive()
        assert outcomes[0] == outcomes[1]
    assert run(lambda: 8, 5.0, "prefill") == 8


def test_fault_plan_and_vocabulary_match_jax(monkeypatch, tmp_path):
    """The port's copies of the resilience vocabulary, the serving
    envelope, the verdict classifier, the retry pacing and the fault
    plan's matching and ``times`` budgets give JAX's answers (the plan
    from the variable and from a file); an unparseable plan raises."""
    from apex_tpu import resilience as jres
    from apex_tpu_torch import resilience as tres

    assert tres.VERDICTS == jres.VERDICTS
    for name in ("SERVE_DISPATCH_TIMEOUT_S", "SERVE_ROUND_ATTEMPTS",
                 "SERVE_ROUND_RETRY_WAIT_S"):
        assert getattr(tres, name) == getattr(jres, name)
    for args in ((0,), (1,), (None, True)):
        assert tres.classify_subprocess(*args) \
            == jres.classify_subprocess(*args)
    jp, tp = jres.RetryPolicy(attempts=2, retry_wait_s=4), \
        tres.RetryPolicy(attempts=2, retry_wait_s=4)
    assert [tp.pop_wait() for _ in range(3)] \
        == [jp.pop_wait() for _ in range(3)] and tp.attempts == jp.attempts
    plan = [{"site": "serve_alloc", "kind": "deny", "times": 2,
             "match_ctx": {"phase": "grow"}},
            {"site": "serve_burst", "kind": "burst", "count": 3,
             "match_ctx": {"tick": 4}, "times": 1},
            {"site": "serve_swap", "kind": "corrupt", "times": 1,
             "match_env": {"APEX_PORT_CHAOS": None}},
            {"site": "serve_decode", "kind": "raise", "message": "gone",
             "match_ctx": {"tick": 3}}]
    calls = [("denied", "serve_alloc", {"phase": "grow", "tick": 1}),
             ("denied", "serve_alloc", {"phase": "admit", "tick": 1})] * 3 \
        + [("burst", "serve_burst", {"tick": 4})] * 2 \
        + [("burst", "serve_burst", {"tick": 5})] \
        + [("corrupt", "serve_swap", {"phase": "swap_in"})] * 2
    for source in ("env", "file"):
        text = json.dumps({"faults": plan})
        if source == "file":
            path = tmp_path / "plan.json"
            path.write_text(text)
            text = str(path)
        monkeypatch.setenv("APEX_FAULT_PLAN", text)
        outcomes = []
        for mod in (jfaults, tfaults):
            mod._cache["fired"] = {}
            got = [getattr(mod, fn)(site, **ctx) for fn, site, ctx in calls]
            for ctx in ({"tick": 2}, {"tick": 3}):
                try:
                    mod.fire("serve_decode", **ctx)
                    got.append(None)
                except RuntimeError as e:
                    got.append(str(e))
            outcomes.append(got)
        assert outcomes[0] == outcomes[1]
        assert outcomes[1][:6] == [True, False, True, False, False, False]
    monkeypatch.setenv("APEX_FAULT_PLAN", "{not json")
    with pytest.raises(ValueError):
        tfaults.plan()
    monkeypatch.delenv("APEX_FAULT_PLAN")
    assert not tfaults.active() and tfaults.plan() == []
