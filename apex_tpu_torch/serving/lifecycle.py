"""Request-lifecycle event log and latency derivation (counterpart of
``apex_tpu/serving/lifecycle.py``).

* :class:`EventLog` — per-request ``submitted / admitted / prefill_done /
  first_token / finished / evicted`` events with wall-clock stamps,
  appended by the engine between device calls. ``validate_order`` checks
  each request's chain against the transition machine below.
* :func:`request_latencies` / :func:`percentile` — TTFT (first-token wall
  minus submit wall) and TPOT ((finish − first token) / (tokens − 1), for
  requests with at least 2 tokens), nearest-rank percentiles.

The resilience, swap and fleet events of the JAX package (``rejected``,
``shed``, ``preempted``, ``failover``, ...) come with the slices that
port those layers; so do the per-round gauges and the SLO ledger block.
"""

EVENTS = ("submitted", "admitted", "prefill_done", "first_token",
          "finished", "evicted")
# events that may appear at most once in a request's chain ("admitted"
# recurs once resubmission is ported)
_ONCE = frozenset(EVENTS) - {"admitted"}
_NEXT = {
    None: ("submitted",),
    "submitted": ("admitted",),
    "admitted": ("prefill_done", "finished"),
    "prefill_done": ("first_token",),
    "first_token": ("finished",),
    "finished": ("evicted",),
    "evicted": (),
}


class EventLog:
    """Append-only per-request lifecycle events."""

    def __init__(self):
        self.events = []          # [{event, rid, tick, wall, seq}]
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
