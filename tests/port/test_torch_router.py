"""Port parity of the fleet router: ``apex_tpu_torch.serving.router``
against ``apex_tpu.serving.router`` (the cases of ``tests/test_router.py``
and ``tests/test_router_chaos.py``).

* The host logic, over stub engines (the router-facing engine surface:
  ``validate_request`` / ``submit(quiet=, replay=)`` / ``step`` /
  ``drain_for_failover`` / ``scheduler`` / ``resilience`` / ``events``):
  the resolvers, the health machine, each routing policy's order, the
  admission refusals, the breaker with failover and probe rejoin, a total
  outage's parked requests, the probe budget, autoscale, the gauges and
  the fleet event log, each scenario run through both routers and every
  outcome compared; and ``router_block`` on the same drained fleets.
* The fleet of three real engines (fp32, one set of weights carried over
  by ``from_jax_params``, one fake clock): with no fault, under a replica
  killed mid-trace (``router_kill``), with the prefix cache, under a
  wedged replica round timed out by the router's watchdog
  (``router_wedge``), a transient failure below the breaker
  (``router_slow``) and a breaker trip with the probe's rejoin, the port's
  fleet gives JAX's fleet's tokens, fleet events, stats, health
  histories and gauges, and a single engine's tokens (zero loss). The
  port's wedged round, woken after its replica was drained, finds the
  engine's epoch moved and does nothing.
"""

import json
import time
import types
import warnings

import pytest
import torch

from apex_tpu.resilience import faults as jfaults
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import engine as jengine_mod
from apex_tpu.serving import lifecycle as jlife
from apex_tpu.serving import router as jrouter
from apex_tpu.serving import scheduler as jsched
from apex_tpu.serving import model as jmodel
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch.resilience import faults as tfaults
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import engine as tengine_mod
from apex_tpu_torch.serving import router as trouter
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

import serving_layers as sl

torch.set_num_threads(2)

PACKAGES = ((jrouter, jsched), (trouter, tsched))


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch):
    monkeypatch.delenv("APEX_FAULT_PLAN", raising=False)
    monkeypatch.delenv("APEX_ROUTE_POLICY", raising=False)
    monkeypatch.delenv("APEX_ROUTE_REPLICAS", raising=False)
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}
    yield
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}


# ------------------------------------------------------- stub engines

class _StubScheduler:
    def __init__(self):
        self.queue = []
        self.completed = []
        self.shed = []

    def queue_depth(self):
        return len(self.queue)

    def active_indices(self):
        return []


class StubEngine:
    """The router-facing engine surface, queue only: ``step`` completes
    one queued request whole (its tokens a function of its rid)."""

    def __init__(self, *, fail_rounds=0, verdict="degraded_relay",
                 prefill_len=16, page_size=4, num_slots=2, overlap=False):
        self.prefill_len = prefill_len
        self.page_size = page_size
        self.num_slots = num_slots
        self.overlap = overlap
        self.scheduler = _StubScheduler()
        self.rejected = []
        self.resilience = types.SimpleNamespace(degraded_rounds=0,
                                                last_verdict=None)
        self.events = None
        self.tick = 0
        self.prefix = None
        self.tokens_generated = 0
        self.fail_rounds = fail_rounds
        self._verdict = verdict
        self.submits = []

    def validate_request(self, request):
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens wants >= 1")

    def submit(self, request, quiet=False, replay=False):
        self.submits.append((request.rid, replay))
        self.scheduler.queue.append(request)
        return None

    def step(self):
        self.tick += 1
        if self.fail_rounds > 0:
            self.fail_rounds -= 1
            self.resilience.last_verdict = self._verdict
            raise RuntimeError("injected replica failure")
        if self.scheduler.queue:
            req = self.scheduler.queue.pop(0)
            req.out_tokens = [req.rid % 7 + i
                              for i in range(req.max_new_tokens)]
            self.tokens_generated += req.max_new_tokens
            self.scheduler.completed.append(req)
        return {}

    def drain_for_failover(self, tick):
        drained, self.scheduler.queue = self.scheduler.queue, []
        return drained


def _req(sched, rid, prompt=None, max_new=4, arrival=0.0):
    return sched.Request(rid=rid, prompt=prompt or [rid + 1, 2, 3, 4, 5],
                         max_new_tokens=max_new, arrival=arrival)


def _summary(rt):
    """Everything a scenario's outcome is compared on."""
    return {
        "stats": dict(rt.stats), "tick": rt.tick,
        "replicas": [(r.name, r.state, list(r.history), r.routed,
                      r.consecutive_failures, r.last_verdict, r.parked,
                      r.probe_attempts_left)
                     for r in rt.replicas],
        "submits": [list(r.engine.submits) for r in rt.replicas],
        "completed": sorted(q.rid for q in rt.completed()),
        "rejected": [(q.rid, x.reason, x.retry_after_ticks)
                     for q, x in rt.rejected],
        "orphans": [q.rid for q in rt._orphans],
        "gauges": rt.gauge_rows(),
        "events": None if rt.events is None else [
            (e["event"], e["rid"], e["tick"]) for e in rt.events.events],
    }


def _both(scenario):
    """``scenario(router_module, scheduler_module)`` for JAX's package (its
    lifecycle collection on) and the port's; returns both results."""
    out = []
    for mod, sched in PACKAGES:
        jlife.enable()
        try:
            out.append(scenario(mod, sched))
        finally:
            jlife.reset_enabled()
    return out


def _drain(rt, reqs, guard=200):
    n = 0
    while not all(r.done() for r in reqs):
        rt.step()
        n += 1
        assert n < guard, [r.out_tokens for r in reqs]


# -------------------------------------------------- resolvers, health

def test_resolvers_and_health_machine_match_jax(monkeypatch):
    assert trouter.ROUTE_POLICIES == jrouter.ROUTE_POLICIES
    assert trouter._HEALTH_NEXT == jrouter._HEALTH_NEXT
    assert trouter.HEALTH_STATES == jrouter.HEALTH_STATES
    for mod in (trouter, jrouter):
        with pytest.raises(ValueError, match="unknown routing policy"):
            mod.resolve_route_policy("bogus")
        for bad in (0, -1, True, "2", 1.5):
            with pytest.raises(ValueError, match="positive int"):
                mod.resolve_route_replicas(bad)
    for env, value in (("APEX_ROUTE_POLICY", "prefix_affinity"),
                       ("APEX_ROUTE_POLICY", "sticky"),
                       ("APEX_ROUTE_REPLICAS", "5"),
                       ("APEX_ROUTE_REPLICAS", "many")):
        monkeypatch.setenv(env, value)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert trouter.resolve_route_policy() \
                == jrouter.resolve_route_policy()
            assert trouter.resolve_route_policy("least_loaded") \
                == "least_loaded"
            assert trouter.resolve_route_replicas() \
                == jrouter.resolve_route_replicas()
        monkeypatch.delenv(env)
    for history in ([], ["degraded"], ["healthy", "degraded", "healthy"],
                    ["healthy", "degraded", "dead", "draining",
                     "rejoined", "healthy"],
                    ["healthy", "degraded", "dead", "healthy"]):
        assert trouter.validate_health(history) \
            == jrouter.validate_health(history)
    r = trouter.Replica(name="r0", engine=StubEngine())
    r.set_state(trouter.DEGRADED)
    with pytest.raises(RuntimeError, match="illegal health transition"):
        r.set_state(trouter.DRAINING)
    assert r.history == ["healthy", "degraded"]
    for mod in (trouter, jrouter):
        mod.AutoscalePolicy(min_replicas=1)
        for bad in (dict(min_replicas=0), dict(min_replicas=True),
                    dict(min_replicas=1, high_water=1.5),
                    dict(min_replicas=1, lag_rounds=0)):
            with pytest.raises(ValueError):
                mod.AutoscalePolicy(**bad)


def test_ctor_demands_raise_as_jax():
    for mod, _ in PACKAGES:
        with pytest.raises(ValueError, match="at least one engine"):
            mod.Router([])
        for engines, kw, words in (
                ([StubEngine(), StubEngine(prefill_len=32)], {},
                 "prefill_len/page_size"),
                ([StubEngine(overlap=True)], {}, "overlapped engine"),
                ([StubEngine()], dict(fleet_admit=-1), "fleet_admit"),
                ([StubEngine()], dict(replica_inflight=True),
                 "replica_inflight"),
                ([StubEngine()], dict(breaker_failures=0),
                 "breaker_failures"),
                ([StubEngine()], dict(policy="sticky"),
                 "unknown routing policy"),
                ([StubEngine()], dict(autoscale="lagged"),
                 "AutoscalePolicy")):
            with pytest.raises(ValueError, match=words):
                mod.Router(engines, **kw)


# --------------------------------------------------- routing scenarios

def _routing(mod, sched):
    out = {}
    rt = mod.Router([StubEngine() for _ in range(3)], policy="round_robin")
    for i in range(4):
        rt.submit(_req(sched, i))
    out["round_robin"] = _summary(rt)
    rt = mod.Router([StubEngine() for _ in range(3)],
                    policy="least_loaded")
    rt.replicas[0].engine.scheduler.queue = [_req(sched, 90),
                                             _req(sched, 91)]
    rt.replicas[2].engine.scheduler.queue = [_req(sched, 92)]
    out["least_loaded"] = [r.name for r in rt._candidates(_req(sched, 1))]
    rt = mod.Router([StubEngine() for _ in range(3)],
                    policy="prefix_affinity")
    system = [9, 8, 7, 6]
    for i in range(6):
        rt.submit(_req(sched, i, prompt=system + [10 + i]))
    out["affinity"] = _summary(rt)
    out["affinity_orders"] = [
        [r.name for r in rt._candidates(_req(sched, 99, prompt=p))]
        for p in ([1, 1, 1, 1, 2], [5, 5, 5, 5, 6], [3, 2, 1, 0, 9])]
    loser = rt._candidates(_req(sched, 1, prompt=[5, 5, 5, 5, 6]))[-1]
    loser.set_state(mod.DEGRADED)
    loser.set_state(mod.DEAD)
    out["affinity_after_death"] = [
        r.name for r in rt._candidates(_req(sched, 1,
                                            prompt=[5, 5, 5, 5, 6]))]
    return out


def test_routing_policies_match_jax():
    want, got = _both(_routing)
    assert got == want
    assert [r[3] for r in got["round_robin"]["replicas"]] == [2, 1, 1]
    assert sorted(r[3] for r in got["affinity"]["replicas"]) == [0, 0, 6]
    assert got["least_loaded"] == ["r1", "r2", "r0"]


def _admission(mod, sched):
    out = []
    rt = mod.Router([StubEngine() for _ in range(2)], fleet_admit=2)
    for i in range(3):
        rt.submit(_req(sched, i))
    out.append(_summary(rt))
    rt = mod.Router([StubEngine() for _ in range(2)], replica_inflight=1)
    for i in range(3):
        rt.submit(_req(sched, i))
    out.append(_summary(rt))
    rt = mod.Router([StubEngine() for _ in range(2)])
    for r in rt.replicas:
        r.set_state(mod.DEGRADED)
        r.set_state(mod.DEAD)
    rt.submit(_req(sched, 0))
    with pytest.raises(ValueError, match="max_new_tokens"):
        rt.submit(_req(sched, 9, max_new=0))
    out.append(_summary(rt))
    return out


def test_admission_refusals_match_jax():
    want, got = _both(_admission)
    assert got == want
    assert [s["rejected"][0][1] for s in got] == ["fleet_full",
                                                  "replica_full",
                                                  "no_replica"]


def _breaker(mod, sched):
    good, bad = StubEngine(), StubEngine(fail_rounds=2)
    rt = mod.Router([good, bad], breaker_failures=2, probe_wait_rounds=1,
                    probe_attempts=3)
    reqs = [_req(sched, i, max_new=2) for i in range(4)]
    for r in reqs:
        rt.submit(r)
    _drain(rt, reqs)
    r1 = rt.replicas[1]
    n = 0
    while r1.state not in (mod.REJOINED, mod.HEALTHY):
        rt.step()
        n += 1
        assert n < 60, r1.history
    rt.step()
    return _summary(rt)


def _outage(mod, sched):
    rt = mod.Router([StubEngine(fail_rounds=1, verdict="wedged")
                     for _ in range(2)], breaker_failures=1,
                    probe_wait_rounds=1)
    reqs = [_req(sched, i, max_new=2) for i in range(3)]
    for r in reqs:
        rt.submit(r)
    rt.step()
    parked = [q.rid for q in rt._orphans]
    _drain(rt, reqs)
    return parked, _summary(rt)


def _budget(mod, sched):
    rt = mod.Router([StubEngine(), StubEngine(fail_rounds=10 ** 6)],
                    breaker_failures=1, probe_wait_rounds=1,
                    probe_attempts=2)
    rt.submit(_req(sched, 0, max_new=1))
    for _ in range(40):
        rt.step()
    return _summary(rt)


def _autoscale(mod, sched):
    rt = mod.Router([StubEngine() for _ in range(2)], policy="round_robin",
                    autoscale=mod.AutoscalePolicy(min_replicas=1,
                                                  high_water=0.5,
                                                  lag_rounds=2))
    reqs = [_req(sched, i, max_new=2) for i in range(5)]
    for r in reqs:
        rt.submit(r)
    _drain(rt, reqs)
    return _summary(rt)


def _no_drain(mod, sched):
    rt = mod.Router([StubEngine(fail_rounds=10 ** 6) for _ in range(2)],
                    breaker_failures=1, probe_wait_rounds=1,
                    probe_attempts=1)
    with pytest.raises(RuntimeError, match="did not drain"):
        rt.run_trace([_req(sched, 0, max_new=1)], max_ticks=50)
    return _summary(rt)


@pytest.mark.parametrize("scenario", [_breaker, _outage, _budget,
                                      _autoscale, _no_drain],
                         ids=lambda f: f.__name__.strip("_"))
def test_health_failover_and_autoscale_match_jax(scenario):
    """The breaker's trip, failover and probe rejoin; a total outage's
    parked requests; the probe budget spent; autoscale's lagged unpark;
    a fleet that cannot drain raising: the same outcome in both."""
    want, got = _both(scenario)
    assert got == want
    summary = got[1] if isinstance(got, tuple) else got
    for name, state, history, *_ in summary["replicas"]:
        assert trouter.validate_health(history) == [], (name, history)
    if scenario is _breaker:
        assert summary["stats"]["deaths"] == 1
        assert summary["stats"]["rejoins"] == 1
        assert summary["completed"] == [0, 1, 2, 3]
    if scenario is _outage:
        assert got[0] and got[1]["completed"] == [0, 1, 2]


def _block(mod, sched):
    rt = mod.Router([StubEngine() for _ in range(2)])
    reqs = [_req(sched, i, max_new=3) for i in range(4)]
    done = rt.run_trace(reqs)
    for i, r in enumerate(done):
        r.enqueue_wall, r.first_token_wall = 0.0, 0.01 * (i + 1)
        r.finish_wall = 0.05 * (i + 1)
    return mod.router_block(rt, done, 1.0, trace_id="tr-unit",
                            arrival_process="poisson",
                            prefix_hit_rate_by_policy={
                                "round_robin": 0.3,
                                "prefix_affinity": 0.4})


def test_router_block_matches_jax():
    want, got = _both(_block)
    assert got == want
    assert got["completed"] == got["requests"] == 4
    assert got["fleet_goodput_tok_s"] == 12.0


def test_fleet_event_log_rebinding():
    rt = trouter.Router([StubEngine() for _ in range(2)])
    assert all(r.engine.events is rt.events for r in rt.replicas)
    rt.submit(_req(tsched, 0))
    assert [e["event"] for e in rt.events.request_events(0)] \
        == ["submitted", "routed"]


# ------------------------------------------------ fleets of real engines

# JAX's router chaos model: one layer, hidden 32, fp32
KW = dict(hidden_size=32, num_layers=1, num_attention_heads=2,
          vocab_size=64, max_position_embeddings=32, hidden_dropout=0.0,
          attention_dropout=0.0, apply_query_key_layer_scaling=False)
ENGINE = dict(num_slots=2, page_size=4, num_pages=32, max_seq=32,
              prefill_len=16)
BASE = [5, 9, 13, 2]    # one full page of shared prefix
TIMEOUT_S = 0.5         # the router's watchdog once warm
HANG_S = 2.0


@pytest.fixture(scope="module")
def tree():
    import jax
    import numpy as np

    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_gpt_params(JConfig(**KW)))


def _fleet_requests(sched):
    return [sched.Request(rid=i, prompt=BASE + [20 + i, 30 + i],
                          max_new_tokens=8, arrival=0.0) for i in range(6)]


def _fleets(tree, monkeypatch, n=3, engine_kw=None, **router_kw):
    """JAX's fleet and the port's (CPU), ``n`` replicas each on one set of
    weights, both routers' and engines' modules on one fake clock."""
    clock = sl.Clock()
    for mod in (jengine_mod, tengine_mod, jrouter, trouter):
        monkeypatch.setattr(mod, "time", clock)
    kw = dict(ENGINE, **(engine_kw or {}))
    jlife.enable()
    try:
        jfleet = jrouter.Router([JEngine(JConfig(**KW), tree, **kw)
                                 for _ in range(n)], **router_kw)
    finally:
        jlife.reset_enabled()
    tcfg = TConfig(**KW)
    params = tweights.from_jax_params(tree, tcfg, "cpu")
    tfleet = trouter.Router([TEngine(tcfg, params, device="cpu", **kw)
                             for _ in range(n)], **router_kw)
    return jfleet, tfleet, clock


def _run_fleet(rt, sched, clock, monkeypatch, plan=None, warm=0,
               timeout=None):
    for mod in (jfaults, tfaults):
        mod._cache["fired"] = {}
    reqs = _fleet_requests(sched)
    clock.now = rt.tick * sl.TICK_S
    for r in reqs:
        assert rt.submit(r) is None
    n = 0
    while not all(r.done() for r in reqs):
        if rt.tick == warm and plan is not None:
            monkeypatch.setenv("APEX_FAULT_PLAN", json.dumps(plan))
            if timeout is not None:
                rt.step_timeout_s = timeout
        clock.now = rt.tick * sl.TICK_S
        rt.step()
        n += 1
        assert n < 150, [r.out_tokens for r in reqs]
    clock.now = rt.tick * sl.TICK_S
    rt.step()
    monkeypatch.delenv("APEX_FAULT_PLAN", raising=False)
    return {
        "tokens": {r.rid: list(r.out_tokens) for r in reqs},
        "stats": dict(rt.stats),
        "health": [(r.state, list(r.history), r.last_verdict)
                   for r in rt.replicas],
        "routed": [r.routed for r in rt.replicas],
        "events": [(e["event"], e["rid"], e["tick"], e["wall"])
                   for e in rt.events.events],
        "gauges": rt.gauge_rows(),
        "completed": sorted(q.rid for q in rt.completed()),
        "hits": [None if r.engine.prefix is None
                 else r.engine.prefix.hit_tokens for r in rt.replicas],
    }


@pytest.fixture(scope="module")
def single(tree):
    """A single engine's tokens for the fleet's requests (zero loss and
    replay parity are held to them)."""
    tcfg = TConfig(**KW)
    eng = TEngine(tcfg, tweights.from_jax_params(tree, tcfg, "cpu"),
                  device="cpu", **ENGINE)
    reqs = _fleet_requests(tsched)
    eng.run_trace(reqs)
    return {r.rid: list(r.out_tokens) for r in reqs}


def _kill(tick, replica):
    return [{"site": "router_kill", "kind": "raise",
             "message": "injected replica death",
             "match_ctx": {"tick": tick, "replica": replica}}]


FLEET_CASES = {
    "no_chaos": (dict(policy="round_robin"), None, None, 0, None),
    "kill": (dict(breaker_failures=1, probe_wait_rounds=64), None,
             _kill(2, "r1"), 0, None),
    "kill_prefix": (dict(breaker_failures=1, probe_wait_rounds=64),
                    dict(prefix_cache=True, num_slots=1), _kill(2, "r0"),
                    0, None),
    "wedge": (dict(breaker_failures=1, probe_wait_rounds=64), None,
              [{"site": "router_wedge", "kind": "hang", "seconds": HANG_S,
                "match_ctx": {"tick": 3, "replica": "r1"}}], 3, TIMEOUT_S),
    "transient": (dict(breaker_failures=2), None,
                  [{"site": "router_slow", "kind": "raise",
                    "message": "transient relay stall",
                    "match_ctx": {"tick": 2, "replica": "r0"}}], 0, None),
    "breaker_rejoin": (dict(breaker_failures=2, probe_wait_rounds=2,
                            probe_attempts=3), None,
                       _kill(2, "r1") + _kill(3, "r1"), 0, None),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_matches_jax_and_a_single_engine(tree, single, monkeypatch,
                                               case):
    router_kw, engine_kw, plan, warm, timeout = FLEET_CASES[case]
    jfleet, tfleet, clock = _fleets(tree, monkeypatch, engine_kw=engine_kw,
                                    **router_kw)
    want = _run_fleet(jfleet, jsched, clock, monkeypatch, plan, warm,
                      timeout)
    got = _run_fleet(tfleet, tsched, clock, monkeypatch, plan, warm,
                     timeout)
    for key in want:
        assert got[key] == want[key], key
    assert got["tokens"] == single
    assert got["completed"] == list(range(6))
    assert tfleet.events.validate_order() == []
    for r in tfleet.replicas:
        assert trouter.validate_health(r.history) == []
        r.engine.allocator.check_invariants()
        if r.engine.prefix is not None:
            r.engine.prefix.check_invariants()
    stats = got["stats"]
    if case == "no_chaos":
        assert got["routed"] == [2, 2, 2] and stats["deaths"] == 0
    elif case == "transient":
        assert stats["deaths"] == 0 and "degraded" in got["health"][0][1]
        assert got["health"][0][0] == "healthy"
    else:
        assert stats["deaths"] == 1 and stats["replayed"] >= 1
    if case == "kill_prefix":
        assert sum(got["hits"]) > 0
    if case == "wedge":
        assert got["health"][1][2] == "wedged"
        # the wedged round wakes on a drained replica: it steps nothing
        engine = tfleet.replicas[1].engine
        deadline = time.monotonic() + 30
        while not engine.stale_steps and time.monotonic() < deadline:
            time.sleep(0.05)
        assert (engine.stale_steps, engine.epoch) == (1, 1)
        assert engine.scheduler.queue_depth() == 0
        assert not engine.scheduler.active_indices()
    if case == "breaker_rejoin":
        r1 = tfleet.replicas[1]
        n = 0
        while r1.state not in ("rejoined", "healthy"):
            tfleet.step()
            n += 1
            assert n < 80, r1.history
        assert tfleet.stats["rejoins"] == 1
        assert trouter.validate_health(r1.history) == []


WEDGE_TICK = 2


@pytest.mark.parametrize("breaker", [1, 2])
def test_round_wedged_in_its_decode_fetch_writes_nothing_after_failover(
        tree, single, monkeypatch, breaker):
    """A replica's round wedges where a real one would: in the fetch of
    its decode tokens, after its launches, with the round's host state
    mid-way. The router's watchdog times it out and the replica is failed
    over, at once or, with the breaker at 2, at the next round: the router
    does not step the replica again beside its running round. Its
    requests replay on the survivors, each from the tokens it was given
    (no placeholder). Woken while they are still served, the round finds
    the drained engine's epoch moved and writes nothing: every stream
    equals a single engine's and finishes once on the fleet log."""
    import threading

    clock = sl.Clock()
    for mod in (tengine_mod, trouter):
        monkeypatch.setattr(mod, "time", clock)
    tcfg = TConfig(**KW)
    params = tweights.from_jax_params(tree, tcfg, "cpu")
    rt = trouter.Router([TEngine(tcfg, params, device="cpu", **ENGINE)
                         for _ in range(3)], breaker_failures=breaker,
                        probe_wait_rounds=64)
    victim = rt.replicas[1].engine
    gate, entered = threading.Event(), threading.Event()
    fetch = victim._fetch_tokens

    def wedged(toks):
        if victim.tick == WEDGE_TICK and not entered.is_set():
            entered.set()
            gate.wait(60)
        return fetch(toks)

    monkeypatch.setattr(victim, "_fetch_tokens", wedged)
    reqs = _fleet_requests(tsched)
    for r in reqs:
        assert rt.submit(r) is None
    killed_at = None
    try:
        while not all(r.done() for r in reqs):
            assert rt.tick < 150, [r.out_tokens for r in reqs]
            if rt.tick == WEDGE_TICK:
                rt.step_timeout_s = TIMEOUT_S
            if killed_at is not None and rt.tick == killed_at + 1:
                # the replayed streams are in flight: wake the round
                assert not all(r.done() for r in reqs)
                gate.set()
                rt.abandoned_workers[0].join(timeout=30)
                assert not rt.abandoned_workers[0].is_alive()
            clock.now = rt.tick * sl.TICK_S
            rt.step()
            if killed_at is None and rt.replicas[1].state == "dead":
                killed_at = rt.tick
        clock.now = rt.tick * sl.TICK_S
        rt.step()
    finally:
        gate.set()
    assert entered.is_set() and killed_at == WEDGE_TICK + breaker
    assert {r.rid: list(r.out_tokens) for r in reqs} == single
    assert sorted(q.rid for q in rt.completed()) == list(range(6))
    finished = [e["rid"] for e in rt.events.events
                if e["event"] == "finished"]
    assert sorted(finished) == list(range(6))
    assert rt.events.validate_order() == []
    r1 = rt.replicas[1]
    assert r1.last_verdict == "wedged" and rt.stats["deaths"] == 1
    assert r1.history[-1] == "dead"
    # the wedged round never finished, and nothing else ran beside it
    assert (victim.stale_steps, victim.epoch, victim.tick) == (
        1, 1, WEDGE_TICK)
    assert not victim.scheduler.active_indices()
    assert victim.scheduler.queue_depth() == 0
    victim.allocator.check_invariants()

