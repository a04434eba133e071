"""Fleet serving: a router over N real engines (counterpart of
``apex_tpu/serving/router.py``; host logic, stdlib only).

One :class:`Router` drives N :class:`~apex_tpu_torch.serving.engine.
ServingEngine` replicas (on one card they share one parameter tree and
each owns its cache and its decode graph) under one trace, with replica
health, failover and composed admission:

* **Routing policies** (``policy=`` > ``APEX_ROUTE_POLICY``:
  ``round_robin`` | ``least_loaded`` | ``prefix_affinity``; a per-call
  unknown policy raises, the preference warns once and falls back):
  ``round_robin`` cycles the routable replicas, ``least_loaded`` takes
  the smallest queued + in-flight count, ``prefix_affinity`` rendezvous-
  hashes the prompt's first-page chain hash (the prefix cache's own
  :func:`~apex_tpu_torch.serving.prefix_cache._page_hash`) over the live
  replicas, so requests that share a system prompt land on one replica
  and prefill it once there.
* **Health** ``healthy -> degraded -> dead -> draining -> rejoined``
  (:func:`validate_health` walks it), fed by the replicas' classified
  failures: a failure escaping a replica's round (or a round its own
  watchdog recovered) marks it ``degraded``; ``breaker_failures`` in a row
  trip the breaker to ``dead``. A dead replica's re-admission is paced
  by :class:`~apex_tpu_torch.resilience.RetryPolicy` in router rounds
  (never a wall sleep, which would stall the healthy replicas): it turns
  ``draining`` and serves a probe request through the real engine; a
  completed probe rejoins it, a failed one returns it to ``dead`` until
  the probe budget is spent.
* **Failover**, with zero loss: a dead replica's
  :meth:`~apex_tpu_torch.serving.engine.ServingEngine.drain_for_failover`
  requeues its in-flight requests as preemption does and hands them,
  with its queued ones, back to the router, which replays them through
  survivors (``submit(..., replay=True)``: past the admission bounds, the
  fleet already accepted them). Greedy decode on shared weights makes the
  replayed streams the single engine's. With no live replica they park
  (``_orphans``) until one rejoins.
* **Admission**: ``replica_inflight`` caps a replica's queued + in-flight
  count, ``fleet_admit`` the fleet's; the refusal says which
  (``fleet_full``, ``replica_full``, ``no_replica``).
  :class:`AutoscalePolicy` keeps replicas past ``min_replicas`` parked
  until fleet load has stayed above ``high_water`` for ``lag_rounds``
  rounds.

The chaos sites ``router_kill`` / ``router_wedge`` / ``router_slow``
(:mod:`apex_tpu_torch.resilience.faults`, tests only) fire inside each
replica's round closure. With ``step_timeout_s`` the round runs under the
serving watchdog; the round keeps the engine's epoch, so a wedged round
that wakes after its replica was drained does nothing.

The router rebinds every replica's event log to ONE fleet
:class:`~apex_tpu_torch.serving.lifecycle.EventLog` and adds ``routed``,
``failover`` and ``replayed`` to the chain; a replica's tick is moved up
to the router's when it is unparked or probed, so ticks never go back.
:func:`router_block` is the fleet's account of a run.
"""

import dataclasses
import hashlib
import math
import time
from typing import Any, List, Optional

from apex_tpu_torch import _env
from apex_tpu_torch import resilience as res_mod
from apex_tpu_torch.resilience import faults as _faults
from apex_tpu_torch.serving import lifecycle
from apex_tpu_torch.serving import resilience as serve_res
from apex_tpu_torch.serving.prefix_cache import ROOT, _page_hash
from apex_tpu_torch.serving.scheduler import Request

ROUTE_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")

# health vocabulary + transition machine (validate_health walks it)
HEALTHY, DEGRADED, DEAD = "healthy", "degraded", "dead"
DRAINING, REJOINED = "draining", "rejoined"
HEALTH_STATES = (HEALTHY, DEGRADED, DEAD, DRAINING, REJOINED)
_HEALTH_NEXT = {
    HEALTHY: (DEGRADED,),
    DEGRADED: (HEALTHY, DEAD),
    DEAD: (DRAINING,),
    DRAINING: (DEAD, REJOINED),
    REJOINED: (HEALTHY, DEGRADED),
}

# circuit breaker + re-admission probe defaults (constructor demands
# override)
ROUTE_BREAKER_FAILURES = 3
ROUTE_PROBE_ATTEMPTS = 3
ROUTE_PROBE_WAIT_ROUNDS = 4
ROUTE_PROBE_ROUNDS = 16     # rounds a probe may run before it counts
#                             as a failed re-admission attempt
_PROBE_RID_BASE = 8_000_000  # fabricated probe rids (serve_burst's
#                              storm uses 9_000_000 — disjoint ranges)


def resolve_route_policy(per_call=None):
    """The effective routing policy: per-call (raises on unknown — an
    explicit request is a demand) > ``APEX_ROUTE_POLICY`` env
    preference (warn-once-and-ignore on unknown) > built-in
    ``round_robin``."""
    if per_call is not None:
        if per_call not in ROUTE_POLICIES:
            raise ValueError(
                f"unknown routing policy {per_call!r} "
                f"(vocabulary: {ROUTE_POLICIES})")
        return per_call
    return _env.env_choice("APEX_ROUTE_POLICY", ROUTE_POLICIES) \
        or "round_robin"


def resolve_route_replicas(per_call=None):
    """The fleet replica count a harness builds: per-call (a positive
    int — anything else raises) > ``APEX_ROUTE_REPLICAS`` env
    preference (garbage warns once and is ignored)
    > built-in 2 (the smallest fleet with a failover survivor)."""
    if per_call is not None:
        if isinstance(per_call, bool) or not isinstance(per_call, int) \
                or per_call < 1:
            raise ValueError(
                f"replicas= wants a positive int, got {per_call!r}")
        return per_call
    return _env.env_int("APEX_ROUTE_REPLICAS") or 2


def validate_health(history):
    """Ordering problems (empty list = clean) of one replica's health
    history: it must start ``healthy`` and walk :data:`_HEALTH_NEXT` —
    the invariant the chaos tests assert, as ``lifecycle.validate_order``
    is for a request's chain."""
    problems = []
    if not history:
        return ["empty health history"]
    if history[0] != HEALTHY:
        problems.append(f"history starts at {history[0]!r}, "
                        f"not 'healthy'")
    for prev, cur in zip(history, history[1:]):
        if cur not in _HEALTH_NEXT.get(prev, ()):
            problems.append(f"{prev!r} -> {cur!r} is not a legal "
                            f"health transition")
    return problems


@dataclasses.dataclass
class Replica:
    """One engine under the router: health state + history, breaker
    and probe bookkeeping, and the per-replica routing account."""
    name: str
    engine: Any
    index: int = 0
    state: str = HEALTHY
    history: List[str] = dataclasses.field(
        default_factory=lambda: [HEALTHY])
    consecutive_failures: int = 0
    last_verdict: Optional[str] = None
    parked: bool = False          # autoscale: built but not yet live
    routed: int = 0               # requests assigned here
    # re-admission probe state (armed at death)
    retry: Any = None             # RetryPolicy
    probe_attempts_left: int = 0
    probe_wait_rounds: int = 0
    probe: Any = None             # the in-flight probe Request
    probe_rounds: int = 0
    _degraded_seen: int = 0       # engine degraded_rounds high-water
    # (worker, engine epoch) of a round the router's watchdog abandoned
    late: Any = None

    def set_state(self, state):
        if state not in _HEALTH_NEXT.get(self.state, ()):
            raise RuntimeError(
                f"replica {self.name}: illegal health transition "
                f"{self.state!r} -> {state!r}")
        self.state = state
        self.history.append(state)

    def routable(self):
        return not self.parked and self.state in (HEALTHY, DEGRADED,
                                                  REJOINED)

    def inflight(self):
        """Queued + in-flight count — the concurrency-limit quantity
        ``least_loaded`` and both admission caps meter."""
        sch = self.engine.scheduler
        return sch.queue_depth() + len(sch.active_indices())


@dataclasses.dataclass
class AutoscalePolicy:
    """Lagged scale-out (the first autoscaling story): replicas beyond
    ``min_replicas`` start parked and one is unparked each time fleet
    load (in-flight over live slot capacity) has held above
    ``high_water`` for ``lag_rounds`` CONSECUTIVE router rounds — the
    reaction lag the static-N vs scale-out A/B measures under the
    diurnal trace. Scale-in is deliberately absent: the first A/B
    isolates scale-OUT lag."""
    min_replicas: int
    high_water: float = 0.75
    lag_rounds: int = 8

    def __post_init__(self):
        if isinstance(self.min_replicas, bool) \
                or not isinstance(self.min_replicas, int) \
                or self.min_replicas < 1:
            raise ValueError(
                f"min_replicas wants a positive int, got "
                f"{self.min_replicas!r}")
        if not 0.0 < float(self.high_water) <= 1.0:
            raise ValueError(
                f"high_water wants a fraction in (0, 1], got "
                f"{self.high_water!r}")
        if isinstance(self.lag_rounds, bool) \
                or not isinstance(self.lag_rounds, int) \
                or self.lag_rounds < 1:
            raise ValueError(
                f"lag_rounds wants a positive int, got "
                f"{self.lag_rounds!r}")


class Router:
    """N real ServingEngine replicas under one routing policy, with
    replica health, circuit-breaking, failover replay and composed
    admission (module docstring). Constructor arguments are per-call
    DEMANDS (garbage raises); only the policy falls back through its
    env preference."""

    def __init__(self, engines, *, policy=None, fleet_admit=0,
                 replica_inflight=0, breaker_failures=None,
                 probe_attempts=None, probe_wait_rounds=None,
                 step_timeout_s=None, autoscale=None, names=None):
        if not engines:
            raise ValueError("Router wants at least one engine")
        self.policy = resolve_route_policy(policy)
        for k, v in (("fleet_admit", fleet_admit),
                     ("replica_inflight", replica_inflight)):
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"{k}= wants a non-negative int (0 = off), "
                    f"got {v!r}")
        self.fleet_admit = fleet_admit
        self.replica_inflight = replica_inflight
        self.breaker_failures = int(
            breaker_failures if breaker_failures is not None
            else ROUTE_BREAKER_FAILURES)
        if self.breaker_failures < 1:
            raise ValueError("breaker_failures wants >= 1")
        self.probe_attempts = int(
            probe_attempts if probe_attempts is not None
            else ROUTE_PROBE_ATTEMPTS)
        self.probe_wait_rounds = int(
            probe_wait_rounds if probe_wait_rounds is not None
            else ROUTE_PROBE_WAIT_ROUNDS)
        self.step_timeout_s = step_timeout_s
        self.probe_rounds_cap = ROUTE_PROBE_ROUNDS
        # replicas must be interchangeable for replay parity and the
        # affinity hash: same prefill bucket, same page geometry. The
        # deferred-fetch overlapped round holds placeholder tokens a
        # failover drain would replay as values — same incompatibility
        # as preemption (engine docstring), so a router over an
        # overlapped engine raises.
        e0 = engines[0]
        for e in engines:
            if e.prefill_len != e0.prefill_len \
                    or e.page_size != e0.page_size:
                raise ValueError(
                    "Router replicas must share prefill_len/page_size "
                    "(failover replays and the affinity hash assume "
                    "interchangeable replicas)")
            if getattr(e, "overlap", False):
                raise ValueError(
                    "Router cannot drive an overlapped engine: the "
                    "deferred-fetch round holds placeholder tokens a "
                    "failover drain would replay as values")
        self.page_size = e0.page_size
        self.replicas = [
            Replica(name=(names[i] if names else f"r{i}"), engine=e,
                    index=i)
            for i, e in enumerate(engines)]
        if autoscale is not None:
            if not isinstance(autoscale, AutoscalePolicy):
                raise ValueError(
                    f"autoscale= wants an AutoscalePolicy or None, "
                    f"got {autoscale!r}")
            for r in self.replicas[autoscale.min_replicas:]:
                r.parked = True
        self.autoscale = autoscale
        self._over_water = 0      # consecutive rounds above high_water
        # ONE fleet event log: every replica's lifecycle events land in
        # it, so validate_order sees the full cross-replica chain
        # (rebinding happens right after engine construction — the
        # per-engine logs it replaces are empty)
        self.events = lifecycle.EventLog()
        for r in self.replicas:
            r.engine.events = self.events
        self.tick = 0
        self._rr = 0              # round-robin cursor
        self._probe_seq = 0
        self.rejected = []        # [(request, Rejected)] at the router
        self._orphans = []        # accepted requests with no live home
        self.abandoned_workers = []   # threads of rounds the watchdog
        #                               timed out
        self._watchdog = serve_res.Watchdog("router-step")
        self.gauges = []          # fleet gauge samples, one a round
        self.stats = {"routed": 0, "failovers": 0, "replayed": 0,
                      "rejected_fleet": 0, "rejected_replica": 0,
                      "deaths": 0, "probes": 0, "rejoins": 0,
                      "scale_outs": 0}

    # --------------------------------------------------------- routing

    def _chain_hash(self, prompt):
        """The prompt's first-page chain hash — the SAME sha1 chain the
        prefix cache keys its pages on, so affinity routing and cache
        hits agree on what "same prefix" means."""
        return _page_hash(ROOT, list(prompt[:self.page_size]))

    def _candidates(self, request):
        """Routable replicas in policy order for *request* (empty when
        the whole fleet is down). ``prefix_affinity`` rendezvous-hashes
        the prompt's chain hash over replica names — stable under
        membership change: a dead replica's keys move, everyone else's
        stay put."""
        routable = [r for r in self.replicas if r.routable()]
        if not routable:
            return []
        if self.policy == "least_loaded":
            return sorted(routable, key=lambda r: (r.inflight(),
                                                   r.index))
        if self.policy == "prefix_affinity":
            chain = self._chain_hash(request.prompt)
            return sorted(
                routable, reverse=True,
                key=lambda r: hashlib.sha1(
                    (chain + r.name).encode()).hexdigest())
        start = self._rr % len(routable)
        self._rr += 1
        return routable[start:] + routable[:start]

    def _record(self, event, rid, wall=None):
        if self.events is not None:
            self.events.record(
                event, rid, tick=self.tick,
                wall=time.perf_counter() if wall is None else wall)

    def fleet_inflight(self):
        return len(self._orphans) + sum(r.inflight()
                                        for r in self.replicas)

    def submit(self, request):
        """Route one request: fleet admission, then the policy's
        candidate order with per-replica concurrency caps — the first
        replica with room takes it (its engine's own admission bound
        still applies underneath). Returns None when routed, else a
        structured ``Rejected`` whose reason names WHICH limit refused:
        ``fleet_full`` (the fleet cap), ``replica_full`` (every
        routable replica at its cap or bound), ``no_replica`` (the
        whole fleet is down/parked). Malformed requests raise before
        anything is recorded — a full fleet rejects load, it never
        masks a programming error."""
        self.replicas[0].engine.validate_request(request)
        slots = sum(r.engine.num_slots for r in self.replicas
                    if r.routable()) or 1
        if self.fleet_admit \
                and self.fleet_inflight() >= self.fleet_admit:
            rej = serve_res.Rejected(
                "fleet_full",
                max(1, -(-self.fleet_inflight() // slots)))
            self.stats["rejected_fleet"] += 1
            self.rejected.append((request, rej))
            wall = time.perf_counter()
            self._record("submitted", request.rid, wall)
            self._record("rejected", request.rid, wall)
            return rej
        order = self._candidates(request)
        reason = "no_replica"
        for r in order:
            reason = "replica_full"
            if self.replica_inflight \
                    and r.inflight() >= self.replica_inflight:
                continue
            if r.engine.submit(request, quiet=True) is None:
                r.routed += 1
                self.stats["routed"] += 1
                wall = time.perf_counter()
                self._record("submitted", request.rid, wall)
                self._record("routed", request.rid, wall)
                return None
            # the engine's own admission bound refused — next candidate
        rej = serve_res.Rejected(
            reason, max(1, -(-self.fleet_inflight() // slots)))
        self.stats["rejected_replica"] += 1
        self.rejected.append((request, rej))
        wall = time.perf_counter()
        self._record("submitted", request.rid, wall)
        self._record("rejected", request.rid, wall)
        return rej

    # ------------------------------------------------ failover + replay

    def _replay(self, requests):
        """Resubmit failed-over requests through survivors. Replays
        BYPASS admission (``replay=True`` — the fleet already accepted
        this load; dropping it at requeue would break the zero-loss
        invariant) and keep their original ``enqueue_wall`` (failover
        must not hide queue latency). With no routable survivor the
        requests park in ``_orphans`` and retry when one rejoins."""
        for req in requests:
            order = self._candidates(req)
            if not order:
                self._orphans.append(req)
                continue
            order[0].engine.submit(req, quiet=True, replay=True)
            self.stats["replayed"] += 1
            self._record("replayed", req.rid)

    def _kill(self, r):
        """Breaker trip: mark *r* dead, drain its queued + in-flight
        requests (the engine frees pages / sets ``resume_tokens`` /
        rebuilds its cache so a later rejoin starts clean), replay
        them through survivors, and arm the RetryPolicy-paced probe
        schedule."""
        r.set_state(DEAD)
        self.stats["deaths"] += 1
        drained = r.engine.drain_for_failover(self.tick)
        self.stats["failovers"] += len(drained)
        wall = time.perf_counter()
        for req in drained:
            self._record("failover", req.rid, wall)
        r.retry = res_mod.RetryPolicy(
            attempts=self.probe_attempts,
            retry_wait_s=self.probe_wait_rounds)
        r.probe_attempts_left = self.probe_attempts
        r.probe_wait_rounds = max(1, int(math.ceil(r.retry.pop_wait())))
        r.probe = None
        self._replay(drained)

    def _note_failure(self, r, verdict):
        """One classified replica failure: health to ``degraded``,
        breaker to ``dead`` at ``breaker_failures`` consecutive."""
        r.last_verdict = verdict
        r.consecutive_failures += 1
        if r.state in (HEALTHY, REJOINED):
            r.set_state(DEGRADED)
        if r.state == DEGRADED \
                and r.consecutive_failures >= self.breaker_failures:
            self._kill(r)

    # ------------------------------------------------------- the round

    def _drive(self, r, phase):
        """One replica round under the chaos sites + optional watchdog.
        Returns the classified verdict on failure, None on a clean
        return. The ``router_kill`` / ``router_wedge`` / ``router_slow``
        sites fire inside the round closure — an injected raise or
        hang lands exactly where a dying replica's dispatch would. The
        round carries the engine's epoch as it started: a round the
        watchdog abandoned that wakes after the replica was drained finds
        the epoch moved and does nothing, or, woken from a wait on the
        device mid-round, stops there (an engine without an epoch is
        stepped plainly). While such a round still runs and its replica
        was not drained, the replica is not stepped beside it: the round
        counts as failing again, ``wedged``."""
        epoch = getattr(r.engine, "epoch", None)
        tick = self.tick
        if r.late is not None:
            worker, at = r.late
            if worker.is_alive() and at == epoch:
                return res_mod.WEDGED
            r.late = None

        def call():
            _faults.fire("router_kill", tick=tick, replica=r.name)
            _faults.fire("router_wedge", tick=tick, replica=r.name)
            _faults.fire("router_slow", tick=tick, replica=r.name)
            if epoch is None:
                return r.engine.step()
            return r.engine.step(epoch=epoch)

        try:
            if self.step_timeout_s:
                self._watchdog.run(call, self.step_timeout_s, phase)
            else:
                call()
        except serve_res.DispatchFailure as f:
            if f.worker is not None:
                self.abandoned_workers.append(f.worker)
                r.late = (f.worker, epoch)
            return f.verdict
        except RuntimeError:
            # a replica died loudly: the router_kill site, or the
            # engine's own SERVE_ROUND_ATTEMPTS budget exhausting —
            # the engine's last classified verdict names the cause
            return r.engine.resilience.last_verdict \
                or res_mod.classify_subprocess(1)
        return None

    def _step_live(self, r):
        verdict = self._drive(r, "router")
        if verdict is not None:
            self._note_failure(r, verdict)
            return
        # a round the engine's OWN watchdog degraded-and-recovered is
        # still a classified failure signal for the breaker
        d = r.engine.resilience.degraded_rounds
        if d > r._degraded_seen:
            r._degraded_seen = d
            self._note_failure(r, r.engine.resilience.last_verdict)
            return
        r.consecutive_failures = 0
        if r.state in (DEGRADED, REJOINED):
            r.set_state(HEALTHY)

    def _tick_dead(self, r):
        if r.probe_attempts_left <= 0:
            return                # probe budget exhausted: stays dead
        r.probe_wait_rounds -= 1
        if r.probe_wait_rounds > 0:
            return
        # paced wait over: start a re-admission probe through the REAL
        # engine (a bare empty round proves nothing — the probe must
        # prefill and decode). Engine tick fast-forwards to the router
        # round so the fleet event log keeps tick monotonicity.
        r.set_state(DRAINING)
        r.probe_attempts_left -= 1
        self.stats["probes"] += 1
        r.engine.tick = self.tick
        self._probe_seq += 1
        probe = Request(rid=_PROBE_RID_BASE + self._probe_seq,
                        prompt=[1, 2, 3], max_new_tokens=2,
                        arrival=float(self.tick))
        r.probe, r.probe_rounds = probe, 0
        self._record("submitted", probe.rid)
        r.engine.submit(probe, quiet=True, replay=True)

    def _probe_failed(self, r):
        r.set_state(DEAD)
        r.probe = None
        r.probe_wait_rounds = max(1, int(math.ceil(r.retry.pop_wait())))

    def _step_probe(self, r):
        verdict = self._drive(r, "router_probe")
        if verdict is not None:
            r.last_verdict = verdict
            self._probe_failed(r)
            return
        r.probe_rounds += 1
        if r.probe.done():
            r.set_state(REJOINED)
            self.stats["rejoins"] += 1
            r.consecutive_failures = 0
            r.probe = None
        elif r.probe_rounds >= self.probe_rounds_cap:
            # a probe that cannot finish is a failed re-admission
            self._probe_failed(r)

    def _autoscale_tick(self):
        if self.autoscale is None:
            return
        live = [r for r in self.replicas if r.routable()]
        cap = sum(r.engine.num_slots for r in live)
        load = (self.fleet_inflight() / cap) if cap else 1.0
        if load > self.autoscale.high_water:
            self._over_water += 1
        else:
            self._over_water = 0
        if self._over_water >= self.autoscale.lag_rounds:
            parked = [r for r in self.replicas if r.parked]
            if parked:
                r = parked[0]
                r.parked = False
                # tick fast-forward: the unparked engine's events must
                # not stamp ticks behind the requests it will serve
                r.engine.tick = self.tick
                self.stats["scale_outs"] += 1
            self._over_water = 0

    def step(self):
        """One fleet round: autoscale decision, then every live
        replica steps (failures classified into the health machine,
        breaker trips drain-and-replay), dead replicas pace their
        probe schedule, draining replicas drive their probe, and
        orphans retry. Returns the router tick just driven."""
        now = self.tick
        self._autoscale_tick()
        for r in self.replicas:
            if r.parked:
                continue
            if r.state == DEAD:
                self._tick_dead(r)
            elif r.state == DRAINING:
                self._step_probe(r)
            else:
                self._step_live(r)
        if self._orphans and any(r.routable() for r in self.replicas):
            orphans, self._orphans = self._orphans, []
            self._replay(orphans)
        self._sample_gauges()
        self.tick += 1
        return now

    def _sample_gauges(self):
        self.gauges.append({
            "step": self.tick,
            "serve_routed": self.stats["routed"],
            "serve_failovers": self.stats["failovers"],
            "serve_replayed": self.stats["replayed"],
        })

    def gauge_rows(self, run=None):
        """The fleet gauge rows, one a router round."""
        if run is None:
            return [dict(g) for g in self.gauges]
        return [dict(g, run=run) for g in self.gauges]

    # ------------------------------------------------------- the trace

    def completed(self):
        """Every completed request across the fleet (probe requests
        excluded — they are router fabrications, not trace load)."""
        out = []
        for r in self.replicas:
            for req in r.engine.scheduler.completed:
                if req.rid < _PROBE_RID_BASE:
                    out.append(req)
        return out

    def run_trace(self, requests, max_ticks=10000):
        """Replay a synthetic trace through the fleet to completion:
        requests are routed when their arrival tick is due; a trace
        request SETTLES by completing on any replica, being shed by
        one, or being rejected at the router. Returns the completed
        Request list. The drain guard raises rather than spinning —
        zero-loss means every ACCEPTED request settles, and a fleet
        that cannot drain must fail loudly."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        n_total = len(pending)
        trace_ids = {id(r) for r in requests}
        cursors = {}

        def _settled():
            n = 0
            lists = [("rej", self.rejected)]
            for r in self.replicas:
                lists.append((f"c{r.index}", r.engine.scheduler.completed))
                lists.append((f"s{r.index}", r.engine.scheduler.shed))
                lists.append((f"r{r.index}", r.engine.rejected))
            for key, lst in lists:
                seen = cursors.get(key, 0)
                for item in lst[seen:]:
                    req = item[0] if isinstance(item, tuple) else item
                    if id(req) in trace_ids:
                        n += 1
                cursors[key] = len(lst)
            return n

        settled = 0
        while settled < n_total or pending:
            settled += _settled()
            if settled >= n_total and not pending:
                break
            if self.tick >= max_ticks:
                raise RuntimeError(
                    f"fleet trace did not drain in {max_ticks} rounds "
                    f"({settled}/{n_total} settled, "
                    f"{len(self._orphans)} orphaned)")
            due = [r for r in pending if r.arrival <= self.tick]
            pending = [r for r in pending if r.arrival > self.tick]
            for req in due:
                self.submit(req)
            self.step()
        return self.completed()


# --------------------------------------------------------------------------
# the fleet's account


def router_block(router, completed, wall_s, *, trace_id,
                 arrival_process, prefix_hit_rate_by_policy=None):
    """The fleet's account of a drained run (the fleet counterpart of
    ``lifecycle.slo_block``; JAX's ``router_block``):

    * ``fleet_goodput_tok_s`` — completed tokens per wall second
      across every replica (rejected/shed load excluded by
      construction — they never generated).
    * ``util_spread`` — max minus min per-replica share of generated
      tokens (0.0 = perfectly even; 1.0 = one replica did everything).
    * ``ttft_p99_ms`` / ``tpot_p99_ms`` — CROSS-replica tails over the
      completed set (``lifecycle.request_latencies`` semantics, so the
      fleet tails can never disagree with the slo block on method).
    * ``failovers`` / ``replayed_requests`` — requests pulled off dead
      replicas and resubmitted through survivors.
    * ``prefix_hit_rate_by_policy`` — per-policy fleet hit rates under
      the shared trace (the harness's policy sweep; None outside it).
    """
    lats = lifecycle.request_latencies(completed)
    ttfts = [x["ttft_s"] * 1e3 for x in lats if x["ttft_s"] is not None]
    tpots = [x["tpot_s"] * 1e3 for x in lats if x["tpot_s"] is not None]
    tokens = [r.engine.tokens_generated for r in router.replicas]
    total = sum(tokens)
    shares = [t / total for t in tokens] if total else []
    spread = (max(shares) - min(shares)) if shares else 0.0

    def _r(v, nd=2):
        return None if v is None else round(v, nd)

    good_tokens = sum(x["n_out"] for x in lats)
    return {
        "route_policy": router.policy,
        "replicas": len(router.replicas),
        "fleet_goodput_tok_s": _r(good_tokens / wall_s
                                  if wall_s > 0 else None),
        "util_spread": _r(spread, 4),
        "ttft_p99_ms": _r(lifecycle.percentile(ttfts, 99)),
        "tpot_p99_ms": _r(lifecycle.percentile(tpots, 99)),
        "failovers": router.stats["failovers"],
        "replayed_requests": router.stats["replayed"],
        "requests": router.stats["routed"],
        "completed": len(lats),
        "rejected_fleet": router.stats["rejected_fleet"],
        "rejected_replica": router.stats["rejected_replica"],
        "prefix_hit_rate_by_policy": prefix_hit_rate_by_policy,
        "trace_id": trace_id,
        "arrival_process": arrival_process,
    }
