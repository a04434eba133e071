"""Request-lifecycle event log, scheduler gauges and latency derivation
(counterpart of ``apex_tpu/serving/lifecycle.py``).

* :class:`EventLog` — per-request ``submitted / admitted / prefill_done /
  first_token / finished / evicted`` events with wall-clock stamps,
  appended by the engine between device calls, plus the resilience
  chain: ``rejected`` (admission control refused at submit) and ``shed``
  (the deadline shedder dropped a queued request) end a chain;
  ``preempted`` (KV pressure) suspends a running request and is followed
  by ``resubmitted``, after which admission may repeat; so is
  ``degraded_round`` (round recovery requeued it); ``swap_failed`` marks a
  swap tier copy that failed (the stream replays by recompute); the fleet
  router adds ``routed``, and ``failover`` (pulled off a dead replica)
  followed by ``replayed`` (resubmitted through a survivor). The
  once-only events still fire at most once across every cycle.
  ``validate_order`` checks each request's chain against the transition
  machine below.
  :meth:`EventLog.sample_gauges` keeps one gauge sample a round (slot
  occupancy, queue depth, live pages, head-of-line wait, and the
  generation and resilience counters); :meth:`EventLog.summary`
  aggregates them.
* :func:`request_latencies` / :func:`percentile` — TTFT (first-token wall
  minus submit wall) and TPOT ((finish − first token) / (tokens − 1), for
  requests with at least 2 tokens), nearest-rank percentiles.
* :func:`slo_block` — the SLO account of a run: TTFT and TPOT p50/p99,
  goodput (tokens of requests that met both thresholds, per wall
  second), attainment, the gauges' high-water marks and the resilience
  rates.
"""

from apex_tpu_torch import _env

EVENTS = ("submitted", "rejected", "shed", "routed", "admitted",
          "prefill_done", "first_token", "preempted", "swap_failed",
          "degraded_round", "resubmitted", "failover", "replayed",
          "finished", "evicted")
# the chain of an undisturbed request
CORE_EVENTS = ("submitted", "admitted", "prefill_done", "first_token",
               "finished", "evicted")
# events that may appear at most once in a request's chain
_ONCE = frozenset(("submitted", "rejected", "shed", "routed",
                   "prefill_done", "first_token", "finished", "evicted"))
# a suspension (KV pressure, a failed round) is followed by resubmitted
_SUSPEND = ("preempted", "degraded_round")
_NEXT = {
    None: ("submitted",),
    "submitted": ("rejected", "shed", "admitted", "routed"),
    "rejected": (),
    "shed": (),
    "routed": ("admitted", "shed", "failover"),
    "admitted": ("prefill_done", "finished", "swap_failed")
    + _SUSPEND + ("failover",),
    "prefill_done": ("first_token",) + _SUSPEND + ("failover",),
    "first_token": ("finished",) + _SUSPEND + ("failover",),
    # a swap tier copy failed: at preemption (preempted -> swap_failed ->
    # resubmitted) or at re-admission (admitted -> swap_failed, then the
    # stream replays by recompute and goes on)
    "preempted": ("resubmitted", "swap_failed"),
    "swap_failed": ("resubmitted", "finished") + _SUSPEND + ("failover",),
    "degraded_round": ("resubmitted",),
    "resubmitted": ("shed", "admitted", "failover"),
    # the fleet router pulled the request off a dead replica; it replays
    # through a survivor
    "failover": ("replayed",),
    "replayed": ("admitted", "shed", "failover"),
    "finished": ("evicted",),
    "evicted": (),
}

# starting-point SLO thresholds (APEX_SERVE_SLO_TTFT_MS /
# APEX_SERVE_SLO_TPOT_MS override them); the deadline shedder reads the
# TTFT one
DEFAULT_SLO_TTFT_MS = 1000.0
DEFAULT_SLO_TPOT_MS = 100.0


def env_ms(name, default):
    """Positive-float preference in ms: the parsed value, else
    ``default`` (garbage warns once and is ignored)."""
    return _env.env_float(name, default)


class EventLog:
    """Append-only per-request lifecycle events and per-round gauges."""

    def __init__(self):
        self.events = []          # [{event, rid, tick, wall, seq}]
        self.gauges = []          # [{tick, wall, serve_*}]
        self._by_rid = {}         # rid -> [event dict]

    def record(self, event, rid, tick=None, wall=None):
        """Append one lifecycle event; unknown event names raise."""
        if event not in EVENTS:
            raise ValueError(f"unknown lifecycle event {event!r} "
                             f"(vocabulary: {EVENTS})")
        rec = {"event": event, "rid": rid, "tick": tick, "wall": wall,
               "seq": len(self.events)}
        self.events.append(rec)
        self._by_rid.setdefault(rid, []).append(rec)
        return rec

    def request_events(self, rid):
        return list(self._by_rid.get(rid, ()))

    def rids(self):
        return sorted(self._by_rid)

    def validate_order(self, rid=None):
        """Ordering problems (empty list = clean) for one request or all:
        events walk ``_NEXT`` from ``submitted``, no ``_ONCE`` event
        repeats, ``finished`` comes only after a first token, and wall
        stamps and ticks never go backwards."""
        problems = []
        rids = [rid] if rid is not None else self.rids()
        for r in rids:
            evs = self._by_rid.get(r, [])
            if not evs:
                problems.append(f"rid {r}: no events")
                continue
            if evs[0]["event"] != "submitted":
                problems.append(
                    f"rid {r}: first event is {evs[0]['event']!r}, "
                    f"not 'submitted'")
            last, last_wall, last_tick = None, None, None
            seen = set()
            for e in evs:
                ev = e["event"]
                if ev in _ONCE and ev in seen:
                    problems.append(f"rid {r}: duplicate event {ev!r}")
                elif last is not None or ev == "submitted":
                    if ev not in _NEXT[last]:
                        problems.append(
                            f"rid {r}: {ev!r} out of order "
                            f"(after {last!r})")
                    elif ev == "finished" and "first_token" not in seen:
                        problems.append(
                            f"rid {r}: 'finished' before any "
                            f"'first_token'")
                seen.add(ev)
                last = ev
                w = e.get("wall")
                if w is not None and last_wall is not None \
                        and w < last_wall:
                    problems.append(
                        f"rid {r}: wall clock went backwards at {ev!r}")
                if w is not None:
                    last_wall = w
                t = e.get("tick")
                if t is not None and last_tick is not None \
                        and t < last_tick:
                    problems.append(
                        f"rid {r}: tick went backwards at {ev!r}")
                if t is not None:
                    last_tick = t
        return problems

    # ------------------------------------------------------------ gauges

    def sample_gauges(self, tick, wall, *, slots_active, num_slots,
                      queue_depth, kv_pages_live, kv_pages_total,
                      hol_wait_s, spec_drafted=0, spec_accepted=0,
                      prefix_hit_tokens=0, rejected=0, shed=0,
                      preempted=0, resubmitted=0, degraded_rounds=0):
        """One gauge sample a scheduler round (the engine takes it at the
        end of each step). The generation and resilience counters are
        cumulative as of this round, 0 where the layer is off."""
        self.gauges.append({
            "tick": tick, "wall": wall,
            "serve_slots_active": int(slots_active),
            "serve_num_slots": int(num_slots),
            "serve_queue_depth": int(queue_depth),
            "serve_kv_pages_live": int(kv_pages_live),
            "serve_kv_pages_total": int(kv_pages_total),
            "serve_hol_wait_ms": round(float(hol_wait_s) * 1e3, 4),
            "serve_spec_drafted": int(spec_drafted),
            "serve_spec_accepted": int(spec_accepted),
            "serve_prefix_hit_tokens": int(prefix_hit_tokens),
            "serve_rejected": int(rejected),
            "serve_shed": int(shed),
            "serve_preempted": int(preempted),
            "serve_resubmitted": int(resubmitted),
            "serve_degraded_rounds": int(degraded_rounds),
        })

    def gauge_rows(self, run=None):
        """Metric rows, one a sample (``step`` = tick)."""
        rows = []
        for g in self.gauges:
            row = {"step": g["tick"]}
            if run is not None:
                row["run"] = run
            row.update({k: v for k, v in g.items()
                        if k not in ("tick", "wall")})
            rows.append(row)
        return rows

    def summary(self):
        """The gauges' aggregate: queue-depth, live-page, occupancy and
        head-of-line high-water marks (None without samples)."""
        if not self.gauges:
            return {"max_queue_depth": None, "kv_page_high_water": None,
                    "max_slots_active": None, "max_hol_wait_ms": None,
                    "samples": 0}
        return {
            "max_queue_depth": max(g["serve_queue_depth"]
                                   for g in self.gauges),
            "kv_page_high_water": max(g["serve_kv_pages_live"]
                                      for g in self.gauges),
            "max_slots_active": max(g["serve_slots_active"]
                                    for g in self.gauges),
            "max_hol_wait_ms": max(g["serve_hol_wait_ms"]
                                   for g in self.gauges),
            "samples": len(self.gauges),
        }


def request_latencies(requests):
    """Per-request latency rows from the engine's wall stamps (seconds,
    host clock): ``{rid, ttft_s, tpot_s, n_out}`` — ``ttft_s`` None when
    either stamp is missing, ``tpot_s`` None for requests with < 2
    tokens."""
    rows = []
    for r in requests:
        n_out = len(getattr(r, "out_tokens", ()) or ())
        ttft = None
        if r.enqueue_wall is not None and r.first_token_wall is not None:
            ttft = max(0.0, r.first_token_wall - r.enqueue_wall)
        tpot = None
        if n_out >= 2 and r.first_token_wall is not None \
                and r.finish_wall is not None:
            tpot = max(0.0, (r.finish_wall - r.first_token_wall)
                       / (n_out - 1))
        rows.append({"rid": r.rid, "ttft_s": ttft, "tpot_s": tpot,
                     "n_out": n_out})
    return rows


def percentile(values, q):
    """Nearest-rank percentile of a list (None when empty)."""
    if not values:
        return None
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(len(vals) * q / 100.0))]


def slo_block(requests, wall_s, *, ttft_ms, tpot_ms, arrival_process,
              offered_load, log=None, resilience=None,
              decode_block_k=1):
    """The SLO account of completed ``requests`` over ``wall_s`` (JAX's
    ``slo_block``): latency percentiles, goodput and attainment against
    ``ttft_ms``/``tpot_ms`` (a request too short for a TPOT is judged on
    TTFT alone), the gauges' summary from ``log`` (None fields without
    it), the engine's ``resilience_rates()`` and its decode block K."""
    lats = request_latencies(requests)
    ttfts = [x["ttft_s"] * 1e3 for x in lats if x["ttft_s"] is not None]
    tpots = [x["tpot_s"] * 1e3 for x in lats if x["tpot_s"] is not None]

    def _attains(x):
        if x["ttft_s"] is None or x["ttft_s"] * 1e3 > ttft_ms:
            return False
        return x["tpot_s"] is None or x["tpot_s"] * 1e3 <= tpot_ms

    attained = [x for x in lats if _attains(x)]
    good_tokens = sum(x["n_out"] for x in attained)
    summary = log.summary() if log is not None else {}

    def _r(v, nd=2):
        return None if v is None else round(v, nd)

    return {
        "ttft_p50_ms": _r(percentile(ttfts, 50)),
        "ttft_p99_ms": _r(percentile(ttfts, 99)),
        "per_token_p50_ms": _r(percentile(tpots, 50)),
        "per_token_p99_ms": _r(percentile(tpots, 99)),
        "goodput_tok_s": _r(good_tokens / wall_s if wall_s > 0 else None),
        "slo_attainment": _r(len(attained) / len(lats) if lats else None,
                             4),
        "slo_ttft_ms": float(ttft_ms),
        "slo_tpot_ms": float(tpot_ms),
        "arrival_process": arrival_process,
        "offered_load": _r(offered_load, 4),
        "requests": len(lats),
        "max_queue_depth": summary.get("max_queue_depth"),
        "kv_page_high_water": summary.get("kv_page_high_water"),
        "max_hol_wait_ms": summary.get("max_hol_wait_ms"),
        "shed_rate": _r((resilience or {}).get("shed_rate"), 4),
        "preempt_rate": _r((resilience or {}).get("preempt_rate"), 4),
        "degraded_rounds": (resilience or {}).get("degraded_rounds"),
        "decode_block_k": int(decode_block_k),
    }
