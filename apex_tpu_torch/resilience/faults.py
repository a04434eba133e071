"""Deterministic fault injection for the serving chaos tests
(``APEX_FAULT_PLAN``) — TEST ONLY (counterpart of the serving and router
sites of ``apex_tpu/resilience/faults.py``; stdlib only).

Never set ``APEX_FAULT_PLAN`` where a number is measured: a plan makes
the engine hang, raise, refuse pages or drop banked bytes on purpose.
The variable holds a JSON fault plan (or a path to one), the same plan
format as the JAX package's, so one plan drives both packages in the
parity tests. Each package keeps its own spend counters (``_cache``):
a test that runs both engines under one plan resets both.

Plan format: a JSON object ``{"faults": [...]}`` or a bare list; each
fault::

    {"site": "serve_alloc" | "serve_prefill" | "serve_decode" |
             "serve_burst" | "serve_swap" |
             "router_kill" | "router_wedge" | "router_slow",
     "kind": "hang" | "raise" | "deny" | "burst" | "corrupt",
     "match_env": {"VAR": "value" | null},   # null = must be unset
     "match_ctx": {"tick": 2, "phase": "grow"},  # the hook's kwargs
     ... kind-specific fields ...}

The sites: ``serve_alloc`` (a page grant, ctx ``tick``/``phase`` ``admit``
or ``grow``: ``deny`` refuses it), ``serve_prefill`` (a packed prefill or
verify call, ctx ``tick``/``step``/``call``), ``serve_decode`` (a decode
program), ``serve_burst`` (a round's start, ctx ``tick``: ``burst``
submits a storm of requests), ``serve_swap`` (a swap tier copy, ctx
``phase`` ``swap_out``/``swap_in``, ``tick``, ``rid``: ``corrupt`` flips a
banked byte), ``router_kill``/``router_wedge``/``router_slow`` (a
replica's round, ctx ``tick``/``replica``).

Kind-specific fields: ``seconds`` (hang: sleep that long then go on;
absent = forever), ``message`` (raise), ``times`` (deny, corrupt, burst:
fire at most N times), ``count``/``prompt_len``/``max_new``/``rid_base``
(burst: the storm's shape). ``hang`` and ``raise`` fire at every match.

Every hook is one environment lookup when the variable is unset.
"""

import hashlib
import json
import os
import sys
import time

ENV = "APEX_FAULT_PLAN"

_cache = {"raw": None, "plan": None, "hash": None, "fired": {}}


def active():
    return bool(os.environ.get(ENV))


def plan():
    """The parsed fault list (possibly empty). An unparseable plan raises
    ValueError: a chaos test with a broken plan must fail, not run
    healthy."""
    raw = os.environ.get(ENV)
    if not raw:
        return []
    if _cache["raw"] == raw:
        return _cache["plan"]
    text = raw
    if not raw.lstrip().startswith(("{", "[")):
        with open(raw) as f:
            text = f.read()
    parsed = json.loads(text)
    faults = parsed.get("faults", []) if isinstance(parsed, dict) \
        else parsed
    if not isinstance(faults, list):
        raise ValueError(f"{ENV}: fault plan must be a list of faults")
    canon = json.dumps(faults, sort_keys=True)
    _cache.update(
        raw=raw, plan=faults, fired={},
        hash="fp-" + hashlib.sha1(canon.encode()).hexdigest()[:10])
    return faults


def plan_hash():
    """``fp-<sha1[:10]>`` of the active plan, or None."""
    if not active():
        return None
    plan()
    return _cache["hash"]


def _match(fault, ctx):
    for k, want in (fault.get("match_env") or {}).items():
        if os.environ.get(k) != want:
            return False
    for k, want in (fault.get("match_ctx") or {}).items():
        if ctx.get(k) != want:
            return False
    return True


def _say(fault, extra=""):
    print(f"# FAULT[{plan_hash()}] site={fault.get('site')} "
          f"kind={fault.get('kind')}{extra}", file=sys.stderr, flush=True)


def _hang(fault):
    _say(fault, f" (sleep {fault.get('seconds', 'forever')})")
    if "seconds" in fault:
        time.sleep(float(fault["seconds"]))
        return
    while True:
        time.sleep(60)


def fire(site, **ctx):
    """Run the matching ``hang`` and ``raise`` faults at ``site``: sleep,
    or raise RuntimeError, where the failing dispatch would."""
    if not active():
        return
    for fault in plan():
        if fault.get("site") != site or not _match(fault, ctx):
            continue
        kind = fault.get("kind")
        if kind == "hang":
            _hang(fault)
        elif kind == "raise":
            _say(fault)
            raise RuntimeError(fault.get(
                "message", f"injected fault at {site}"))


def _spend(idx, fault):
    """True when the fault at plan index ``idx`` still has budget under its
    optional ``times`` cap, consuming one firing."""
    if "times" not in fault:
        return True
    n = _cache["fired"].get(idx, 0)
    if n >= int(fault["times"]):
        return False
    _cache["fired"][idx] = n + 1
    return True


def denied(site, **ctx):
    """True when a matching ``deny`` fault refuses this page grant (the
    scheduler treats it as an empty free list)."""
    if not active():
        return False
    for idx, fault in enumerate(plan()):
        if fault.get("site") != site or fault.get("kind") != "deny" \
                or not _match(fault, ctx):
            continue
        if _spend(idx, fault):
            _say(fault, f" (alloc refused, ctx={ctx})")
            return True
    return False


def corrupt(site, **ctx):
    """True when a matching ``corrupt`` fault wants the caller's banked
    host bytes damaged (the handle's seal must then catch it)."""
    if not active():
        return False
    for idx, fault in enumerate(plan()):
        if fault.get("site") != site or fault.get("kind") != "corrupt" \
                or not _match(fault, ctx):
            continue
        if _spend(idx, fault):
            _say(fault, f" (corrupt banked bytes, ctx={ctx})")
            return True
    return False


def burst(site, **ctx):
    """The matching ``burst`` fault (the engine builds and submits the
    storm it describes), or None."""
    if not active():
        return None
    for idx, fault in enumerate(plan()):
        if fault.get("site") != site or fault.get("kind") != "burst" \
                or not _match(fault, ctx):
            continue
        if _spend(idx, fault):
            _say(fault, f" (burst ctx={ctx})")
            return fault
    return None
