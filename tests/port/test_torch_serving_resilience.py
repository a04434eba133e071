"""Port parity of serving's page-pressure layers: admission control,
deadline shedding, KV-pressure preemption and the host swap tier,
``apex_tpu_torch.serving`` against ``apex_tpu.serving``.

* The engines (fp32, one set of weights, one fake clock:
  ``serving_layers.py``) emit the same tokens at the same ticks and keep
  the same counters, rate accounts (``resilience_rates``,
  ``kv_tier_rates``), event logs (the preempted / resubmitted, rejected
  and shed chains) and gauges, under preemption restored by swap and by
  recompute, composed with the prefix cache, the int8 KV tier,
  ``decode_k=4`` (a resumed stream's overflow on the warm-token feed) and
  speculative decode, and under admission control and shedding against a
  burst. Streams restored by swap give the never-preempted run's tokens.
* ``_select_victim`` and ``grow`` make JAX's decisions on
  hypothesis-drawn schedulers; ``SwappedPages`` seals JAX's digest over
  the same bytes (bf16, int8 and fp32 leaves) and refuses changed bytes.
* The knobs resolve as JAX's: ``recover`` and ``overlap`` resolve and
  pair with preemption, speculation and each other as JAX's do, and
  ``tp``, a later slice of the port, raises and names it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import kv_tier as jtier
from apex_tpu.serving import lifecycle as jlife
from apex_tpu.serving import resilience as jres
from apex_tpu.serving import scheduler as jsched
from apex_tpu_torch import _env
from apex_tpu_torch.serving import Rejected, Request
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import kv_tier as ttier
from apex_tpu_torch.serving import lifecycle as tlife
from apex_tpu_torch.serving import resilience as tres
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

import serving_layers as sl

torch.set_num_threads(2)

# 9 allocatable pages: above one request's 8 at max_seq 64 (the progress
# guarantee), below what three growing streams need
SMALL = 10


@pytest.fixture(scope="module")
def jax_tree():
    return sl.jax_tree()


def _burst(sched):
    """Twelve short requests submitted at once, before the first round."""
    rs = np.random.RandomState(5)
    return [sched.Request(rid=100 + i, prompt=[int(t) for t in rs.randint(
        0, 256, 6)], max_new_tokens=4) for i in range(12)]


PREEMPT_CASES = {
    "recompute": (sl.LONG, dict(preempt=True, num_pages=SMALL)),
    "swap": (sl.LONG, dict(preempt=True, kv_swap=True, num_pages=SMALL)),
    "swap_restore_recompute": (sl.LONG, dict(
        preempt=True, kv_swap=True, kv_restore="recompute",
        num_pages=SMALL)),
    "swap_int8": (sl.LONG, dict(preempt=True, kv_swap=True, kv_quant=True,
                                num_pages=SMALL)),
    "recompute_int8": (sl.LONG, dict(preempt=True, kv_quant=True,
                                     num_pages=SMALL)),
    "swap_prefix": (dict(sl.SYSTEM_TRACE, new_lo=20, new_hi=40), dict(
        preempt=True, kv_swap=True, prefix_cache=True, num_pages=SMALL)),
    "recompute_prefix": (dict(sl.SYSTEM_TRACE, new_lo=20, new_hi=40), dict(
        preempt=True, prefix_cache=True, num_pages=SMALL)),
    "swap_k4_warm_feed": (sl.LONG, dict(preempt=True, kv_swap=True,
                                        decode_k=4, num_pages=SMALL)),
    "recompute_k4_warm_feed": (sl.LONG, dict(preempt=True, decode_k=4,
                                             num_pages=SMALL)),
    "swap_spec2": (sl.LONG, dict(preempt=True, kv_swap=True, spec_decode=2,
                                 num_pages=SMALL)),
}


@pytest.mark.parametrize("case", list(PREEMPT_CASES))
def test_preemption_engine_matches_jax(jax_tree, monkeypatch, case):
    spec, kw = PREEMPT_CASES[case]
    te, got = sl.parity(jax_tree, monkeypatch, spec, **kw)
    assert te.resilience.preempted > 0, "nothing was preempted"
    chains = [[e["event"] for e in te.events.request_events(rid)]
              for rid in te.events.rids()]
    assert any("preempted" in c for c in chains)
    for c in chains:
        if "preempted" in c:
            i = c.index("preempted")
            assert c[i + 1] == "resubmitted" and "admitted" in c[i + 2:]
    if te.kv_swap:
        st_ = te.kv_stats
        assert st_.swapped_pages_live == 0
        if te.kv_restore != "recompute":
            assert st_.swap_ins > 0 and st_.restores_swap == st_.swap_ins


@pytest.mark.parametrize("kw", [dict(preempt=True, kv_swap=True),
                                dict(preempt=True, kv_swap=True,
                                     kv_quant=True)],
                         ids=["bf16_pages", "int8_pages"])
def test_swap_restored_streams_give_the_unpreempted_tokens(jax_tree, kw):
    """Pages come back byte for byte, so a stream restored by swap-in
    continues exactly as if never preempted."""
    cfg = TConfig(**sl.KW)
    from apex_tpu_torch.serving import weights as tweights

    params = tweights.from_jax_params(jax_tree, cfg, "cpu")
    out = {}
    for pool in (sl.ENGINE["num_pages"], SMALL):
        extra = dict(kw, num_pages=pool) if pool == SMALL \
            else {"kv_quant": kw.get("kv_quant")}
        eng = TEngine(cfg, params, device="cpu",
                      **dict(sl.ENGINE, **extra))
        done = eng.run_trace(sl.trace(tsched, sl.LONG))
        out[pool] = ({r.rid: r.out_tokens for r in done}, eng)
    eng = out[SMALL][1]
    assert eng.kv_stats.swap_ins > 0
    assert out[SMALL][0] == out[sl.ENGINE["num_pages"]][0]
    # every staging buffer is back in the pool, and the pool reused them
    sizes = {len(bufs) for bufs in eng._host_pool.values()}
    assert len(sizes) == 1 and 1 <= sizes.pop() < eng.kv_stats.swap_outs


def test_swap_staging_pool_takes_the_smallest_fit():
    """The swap tier's host buffers: one of max_pages made with the
    engine; a bank takes the smallest pooled buffer that holds it, else a
    new one of the next power of two of pages."""
    eng = TEngine(TConfig(**sl.KW), device="cpu", preempt=True,
                  kv_swap=True, **sl.ENGINE)
    leaf = eng.cache["k"]
    per_page = leaf[:, :, 0].numel()
    assert [b.numel() for b in eng._host_pool["k"]] \
        == [per_page * eng.max_pages]
    first = eng._staging("k", leaf, 3)
    assert first.numel() == per_page * eng.max_pages
    second = eng._staging("k", leaf, 3)
    assert second.numel() == per_page * 4 and not eng._host_pool["k"]
    eng._host_pool["k"] += [first, second]
    assert eng._staging("k", leaf, 2) is second
    assert eng._staging("k", leaf, 5) is first
    assert eng._staging("k", leaf, 1).numel() == per_page


def test_burst_admission_and_shedding_match_jax(jax_tree, monkeypatch):
    """Twelve requests at once into a queue bound at 4: the overflow is
    rejected at submit with JAX's Rejected; queued requests that wait
    past the TTFT threshold (0.25 s, 2.5 ticks of the fake clock) are shed
    before admission; neither takes a slot."""
    te, got = sl.parity(jax_tree, monkeypatch, dict(sl.TRACE, n_requests=4),
                        burst=_burst, admit=4, shed=True, shed_ttft_ms=250.0)
    assert got["rejected"] and got["shed"]
    for rid, reason, retry in got["rejected"]:
        assert reason == "queue_full" and retry >= 1
        chain = [e["event"] for e in te.events.request_events(rid)]
        assert chain == ["submitted", "rejected"]
    for rid in got["shed"]:
        chain = [e["event"] for e in te.events.request_events(rid)]
        assert chain == ["submitted", "shed"]
        assert got["requests"][rid][0] == [] \
            and got["requests"][rid][1] is None
    assert te.resilience_rates()["shed_rate"] > 0


def test_all_layers_armed_without_pressure_match_jax(jax_tree, monkeypatch):
    """Admission, shedding and preemption on with nothing triggering them
    (a roomy pool and queue, a lax threshold): the plain engine's tokens,
    and zero rates."""
    te, got = sl.parity(jax_tree, monkeypatch, sl.TRACE, admit=16,
                        shed=True, shed_ttft_ms=1e6, preempt=True,
                        kv_swap=True)
    assert got["resilience"] == {"shed_rate": 0.0, "preempt_rate": 0.0,
                                 "degraded_rounds": None}
    assert got["kv_tier"] == {"kv_quant": None, "swap_rate": 0.0,
                              "swapped_pages_high_water": 0}
    plain = TEngine(te.cfg, device="cpu", **sl.ENGINE,
                    params=sl.tweights.from_jax_params(jax_tree, te.cfg,
                                                       "cpu"))
    done = plain.run_trace(sl.trace(tsched, sl.TRACE))
    assert {r.rid: r.out_tokens for r in done} \
        == {rid: v[0] for rid, v in got["requests"].items()}


def test_submit_rejects_structurally_and_never_masks_a_bad_request():
    cfg = TConfig(**sl.KW)
    eng = TEngine(cfg, device="cpu", **dict(sl.ENGINE, num_slots=1),
                  admit=2)
    rs = [Request(rid=i, prompt=[1, 2, 3], max_new_tokens=4)
          for i in range(5)]
    results = [eng.submit(r) for r in rs]
    assert [isinstance(x, Rejected) for x in results] \
        == [False, False, True, True, True]
    assert results[2] == Rejected("queue_full", 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(rid=9, prompt=[1], max_new_tokens=0))
    off = TEngine(cfg, device="cpu", **dict(sl.ENGINE, num_slots=1))
    assert all(off.submit(Request(rid=i, prompt=[1, 2], max_new_tokens=2))
               is None for i in range(10, 20))


# ------------------------------------------------------------ unit parity

slot_spec = st.tuples(st.integers(0, 2),            # priority
                      st.integers(0, 5),            # admitted tick
                      st.integers(1, 20),           # prompt length
                      st.integers(0, 6),            # tokens generated
                      st.booleans())                # finished


@settings(max_examples=60, deadline=None)
@given(slots=st.lists(slot_spec, min_size=1, max_size=4),
       grows=st.lists(st.tuples(st.integers(0, 3), st.integers(1, 8)),
                      max_size=6),
       pages=st.integers(9, 14))
def test_select_victim_and_grow_match_jax(slots, grows, pages):
    """The same seated slots in JAX's scheduler and the port's (preempt
    mode, prompt pages only), then the same growth requests: the same
    victims, grants, preemptions, requeued streams and page accounting."""
    states = []
    for sched, kv in ((tsched, tkv), (jsched, jkv)):
        alloc = kv.PageAllocator(pages)
        s = sched.ContinuousBatchingScheduler(len(slots), 8, 4, alloc,
                                              preempt=True)
        for i, (prio, tick, plen, gen, done) in enumerate(slots):
            req = sched.Request(rid=i, prompt=list(range(plen)),
                                max_new_tokens=gen + (0 if done else 3)
                                or 1, priority=prio)
            s.submit(req, tick=0)
        s.admit(0)
        for i, slot in enumerate(s.slots):
            if slot is None:
                continue
            prio, tick, plen, gen, done = slots[slot.request.rid]
            slot.request.admitted_tick = tick
            slot.request.out_tokens = list(range(gen))
        log = [s._select_victim(7)]
        for i, want in grows:
            if i < len(s.slots) and s.slots[i] is not None:
                log.append((i, s.grow(i, want, 7),
                            [r.rid for r in s.take_preempted()]))
        log.append(([None if x is None else (x.request.rid, list(x.pages))
                     for x in s.slots],
                    [(r.rid, r.resume_tokens, r.preemptions)
                     for r in s.queue], alloc.free_count))
        alloc.check_invariants()
        states.append(log)
    assert states[0] == states[1]


LEAVES = {"k": (np.int8, (2, 3, 2, 4, 8)), "v": (np.int8, (2, 3, 2, 4, 8)),
          "k_scale": ("bf16", (2, 3, 2)), "v_scale": ("bf16", (2, 3, 2)),
          "x": (np.float32, (2, 3, 2, 4, 8))}


@pytest.mark.parametrize("quant", [False, True])
def test_swapped_pages_digest_matches_jax(quant):
    rs = np.random.RandomState(3)
    jleaves, tleaves = {}, {}
    names = ("k", "v", "k_scale", "v_scale") if quant else ("x",)
    for name in names:
        dtype, shape = LEAVES[name]
        if dtype == "bf16":
            bits = rs.randint(0, 2**15, shape).astype(np.uint16)
            jleaves[name] = bits.view(jnp.bfloat16)
            tleaves[name] = torch.from_numpy(bits.view(np.int16)).view(
                torch.bfloat16)
        else:
            arr = (rs.randint(-127, 128, shape) if dtype == np.int8
                   else rs.randn(*shape)).astype(dtype)
            jleaves[name] = arr
            tleaves[name] = torch.from_numpy(arr.copy())
    j = jtier.SwappedPages(leaves=jleaves, page_count=2, tokens=7,
                           quant=quant).seal()
    t = ttier.SwappedPages(leaves=tleaves, page_count=2, tokens=7,
                           quant=quant).seal()
    assert t.checksum == j.checksum and t.intact()
    assert t.nbytes() == j.nbytes()
    tleaves[names[0]].view(torch.uint8).view(-1)[0] ^= 0xFF
    assert not t.intact()


def test_kv_tier_stats_match_jax():
    t, j = ttier.KVTierStats(), jtier.KVTierStats()
    for stats, mod, leaves in (
            (t, ttier, {"k": torch.zeros(2, 2, 3, 4)}),
            (j, jtier, {"k": np.zeros((2, 2, 3, 4), np.float32)})):
        h = mod.SwappedPages(leaves=leaves, page_count=3, tokens=9,
                             quant=False)
        stats.banked(h)
        stats.banked(h)
        stats.released(h)
    shared = ("swap_outs", "swap_ins", "restores_swap",
              "restores_recompute", "swapped_pages_live",
              "swapped_pages_high_water", "swapped_bytes_live",
              "swapped_bytes_high_water")
    assert [getattr(t, k) for k in shared] == [getattr(j, k) for k in shared]


def test_lifecycle_suspension_chains_match_jax():
    chains = {0: ("submitted", "admitted", "prefill_done", "first_token",
                  "preempted", "resubmitted", "admitted", "finished",
                  "evicted"),
              1: ("submitted", "rejected"),
              2: ("submitted", "shed"),
              3: ("submitted", "admitted", "preempted", "resubmitted",
                  "shed"),
              4: ("submitted", "admitted", "preempted", "admitted"),
              5: ("submitted", "rejected", "admitted"),
              6: ("submitted", "admitted", "prefill_done", "first_token",
                  "preempted", "resubmitted", "admitted", "prefill_done"),
              7: ("submitted", "shed", "shed")}
    tl, jl = tlife.EventLog(), jlife.EventLog()
    for rid, chain in chains.items():
        for tick, ev in enumerate(chain):
            tl.record(ev, rid, tick=tick, wall=float(tick))
            jl.record(ev, rid, tick=tick, wall=float(tick))
    assert tl.validate_order() == jl.validate_order()
    assert [r for r in chains if not tl.validate_order(r)] == [0, 1, 2, 3]
    g = dict(slots_active=2, num_slots=3, queue_depth=4, kv_pages_live=5,
             kv_pages_total=9, hol_wait_s=0.0123456, spec_drafted=7,
             rejected=1, preempted=2, resubmitted=2)
    for log in (tl, jl):
        log.sample_gauges(tick=0, wall=0.0, **g)
        log.sample_gauges(tick=1, wall=1.0, **dict(g, queue_depth=1))
    assert tl.gauges == jl.gauges
    assert tl.gauge_rows(run="r") == jl.gauge_rows(run="r")
    assert tl.summary() == jl.summary()
    assert tlife.EventLog().summary() == jlife.EventLog().summary()


# -------------------------------------------------------------------- knobs

def test_resilience_and_swap_knob_asymmetry(monkeypatch):
    for name in ("APEX_SERVE_ADMIT", "APEX_SERVE_SHED", "APEX_SERVE_PREEMPT",
                 "APEX_SERVE_RECOVER", "APEX_SERVE_KV_SWAP",
                 "APEX_SERVE_KV_RESTORE", "APEX_SERVE_SLO_TTFT_MS"):
        monkeypatch.delenv(name, raising=False)
    for bad in (-1, 1.5, "4", True):
        with pytest.raises(ValueError, match="admit="):
            tres.resolve_admit(bad)
        with pytest.raises(ValueError):
            jres.resolve_admit(bad)
    assert tres.resolve_admit(False) == tres.resolve_admit() == 0
    assert tres.resolve_admit(3) == 3
    monkeypatch.setenv("APEX_SERVE_ADMIT", "5")
    assert tres.resolve_admit() == 5 == jres.resolve_admit()
    _env._warned_env.clear()
    monkeypatch.setenv("APEX_SERVE_ADMIT", "lots")
    with pytest.warns(UserWarning, match="lots"):
        assert tres.resolve_admit() == 0
    for fn, jfn, env in (
            (tres.resolve_shed, jres.resolve_shed, "APEX_SERVE_SHED"),
            (tres.resolve_preempt, jres.resolve_preempt,
             "APEX_SERVE_PREEMPT"),
            (tres.resolve_recover, jres.resolve_recover,
             "APEX_SERVE_RECOVER")):
        with pytest.raises(ValueError, match="True/False/None"):
            fn(1)
        with pytest.raises(ValueError):
            jfn(1)
        assert fn() is False is jfn()
        monkeypatch.setenv(env, "1")
        assert fn() is True is jfn() and fn(False) is False
        monkeypatch.setenv(env, "maybe")
        with pytest.warns(UserWarning, match="maybe"):
            assert fn() is False
    assert ttier.resolve_kv_swap() is False
    monkeypatch.setenv("APEX_SERVE_KV_SWAP", "1")
    assert ttier.resolve_kv_swap() is True and not ttier.resolve_kv_swap(0)
    monkeypatch.setenv("APEX_SERVE_KV_SWAP", "on")
    with pytest.warns(UserWarning, match="on"):
        assert ttier.resolve_kv_swap() is False
    monkeypatch.setenv("APEX_SERVE_KV_RESTORE", "disk")
    with pytest.warns(UserWarning, match="disk"):
        assert ttier.resolve_kv_restore(swap_enabled=True) == "swap"
    monkeypatch.setenv("APEX_SERVE_SLO_TTFT_MS", "-3")
    with pytest.warns(UserWarning, match="-3"):
        assert tlife.env_ms("APEX_SERVE_SLO_TTFT_MS", 1000.0) == 1000.0
    with pytest.raises(ValueError, match="unknown kv_restore"):
        ttier.resolve_kv_restore("disk", swap_enabled=True)
    with pytest.raises(ValueError, match="never banked"):
        ttier.resolve_kv_restore("swap", swap_enabled=False)
    assert ttier.resolve_kv_restore(swap_enabled=False) == "recompute"
    assert ttier.resolve_kv_restore(swap_enabled=True) == "swap"
    monkeypatch.setenv("APEX_SERVE_KV_RESTORE", "recompute")
    assert ttier.resolve_kv_restore(swap_enabled=True) == "recompute"
    assert ttier.resolve_kv_restore("swap", swap_enabled=True) == "swap"


def test_engine_resilience_pairings_match_jax(monkeypatch, jax_tree):
    """preempt=True over a pool that cannot grow one request to max_seq
    raises, the preference falls back; kv_swap=True without preemption
    raises, the preference falls back; kv_restore="swap" without the
    tier raises; shed_ttft_ms wants a positive number; tp asks for a
    later slice and raises naming it; overlap pairs with preempt,
    recover and spec_decode as JAX's engine does: two demands raise, a
    demand drops the other side's preference, two preferences keep the
    serial round (each resolution compared with JAX's engine built the
    same way)."""
    for name in ("APEX_SERVE_PREEMPT", "APEX_SERVE_KV_SWAP",
                 "APEX_SERVE_SLO_TTFT_MS", "APEX_SERVE_RECOVER",
                 "APEX_SERVE_OVERLAP", "APEX_SPEC_DECODE"):
        monkeypatch.delenv(name, raising=False)
    cfg = TConfig(**sl.KW)

    def build(**extra):
        return TEngine(cfg, device="cpu", **dict(sl.ENGINE, **extra))

    with pytest.raises(ValueError, match="progress|wedge"):
        build(preempt=True, num_pages=8)
    with pytest.raises(ValueError, match="kv_swap=True cannot be honored"):
        build(kv_swap=True)
    with pytest.raises(ValueError, match="never banked"):
        build(preempt=True, kv_restore="swap")
    with pytest.raises(ValueError, match="unknown kv_restore"):
        build(kv_restore="disk")
    for bad in (0, -5, True, "9"):
        with pytest.raises(ValueError, match="shed_ttft_ms="):
            build(shed_ttft_ms=bad)
    with pytest.raises(ValueError, match="tensor-parallel"):
        build(tp=2)
    jcfg = sl.JConfig(**sl.KW)

    def resolved(e):
        return (e.overlap, e.preempt, e.recover, e.spec_k, e.decode_k)

    for extra in (dict(overlap=True, preempt=True),
                  dict(overlap=True, recover=True),
                  dict(overlap=True, spec_decode=2),
                  dict(overlap="yes"), dict(recover=1)):
        with pytest.raises(ValueError):
            sl.JEngine(jcfg, jax_tree, **dict(sl.ENGINE, **extra))
        with pytest.raises(ValueError):
            build(**extra)
    for env, cases in (
            ({}, ({}, dict(overlap=True), dict(recover=True),
                  dict(overlap=True, spec_decode=None, decode_k=4))),
            ({"APEX_SERVE_PREEMPT": "1", "APEX_SERVE_RECOVER": "1"},
             ({}, dict(overlap=True), dict(preempt=False))),
            ({"APEX_SERVE_OVERLAP": "1"},
             ({}, dict(preempt=True), dict(recover=True),
              dict(spec_decode=2))),
            ({"APEX_SERVE_OVERLAP": "1", "APEX_SPEC_DECODE": "2"},
             ({}, dict(overlap=True), dict(overlap=False))),
            ({"APEX_SERVE_OVERLAP": "1", "APEX_SERVE_PREEMPT": "1"},
             ({},))):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for extra in cases:
            want = resolved(sl.JEngine(jcfg, jax_tree,
                                       **dict(sl.ENGINE, **extra)))
            assert resolved(build(**extra)) == want, (env, extra)
        for k in env:
            monkeypatch.delenv(k)
    e = build(recover=True, dispatch_timeout_s=7, round_attempts=5,
              round_retry_wait_s=0)
    assert (e.recover, e.dispatch_timeout_s, e.round_attempts,
            e._round_retry.retry_wait) == (True, 7.0, 5, 0)
    assert e.resilience_rates()["degraded_rounds"] == 0
    e = build(recover=False, overlap=False, tp=1, preempt=True,
              kv_swap=True)
    assert e.preempt and e.kv_swap and e.kv_stats is not None
    monkeypatch.setenv("APEX_SERVE_PREEMPT", "1")
    monkeypatch.setenv("APEX_SERVE_KV_SWAP", "1")
    e = build(num_pages=8)
    assert not e.preempt and not e.kv_swap and e.kv_stats is None
    monkeypatch.setenv("APEX_SERVE_SLO_TTFT_MS", "250")
    assert build().shed_ttft_ms == 250.0
    assert build(shed_ttft_ms=40).shed_ttft_ms == 40.0
