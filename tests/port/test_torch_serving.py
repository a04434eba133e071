"""Port parity of the serving slice: apex_tpu_torch.serving against
apex_tpu.serving on one set of weights (the JAX GPTModel init, carried
across by from_jax_params) and the same numpy/trace inputs.

* the weight converter round trip is bit-exact;
* prefill and decode logits match ``apex_tpu.serving.model`` within
  2e-4 (fp32) and 0.35 (bf16, the band of tests/test_serving.py), and
  the paged cache holds the same K/V at the same (page, offset) — the
  scatter-placement hazard (JAX puts the token axis first, torch at the
  index position);
* the port's ServingEngine matches the JAX ServingEngine token for token
  in fp32 on one synthetic_trace;
* the scheduler, allocator, synthetic_trace, lifecycle and env-knob
  copies behave as their originals.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.dispatch import tiles as jtiles
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import lifecycle as jlife
from apex_tpu.serving import model as jmodel
from apex_tpu.serving import scheduler as jsched
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch import _env
from apex_tpu_torch.ops import decode_attention_cuda
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import lifecycle as tlife
from apex_tpu_torch.serving import model as tmodel
from apex_tpu_torch.serving import sampling as tsampling
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

torch.set_num_threads(2)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
          attention_dropout=0.0, apply_query_key_layer_scaling=False)
PS = 8
ENGINE = dict(num_slots=3, page_size=PS, num_pages=24, max_seq=64,
              prefill_len=32)
TRACE = dict(seed=3, n_requests=10, vocab=128, prompt_lo=3, prompt_hi=14,
             new_lo=1, new_hi=12)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX GPTModel init as numpy (params are fp32 under bf16 too)."""
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_gpt_params(JConfig(**KW)))


def _cfgs(bf16):
    return JConfig(**KW, bf16=bf16), TConfig(**KW, bf16=bf16)


def test_converter_round_trip_is_bit_exact(jax_tree):
    cfg = TConfig(**KW)
    back = tweights.to_numpy_tree(
        tweights.from_jax_params(jax_tree, cfg, "cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path


def test_converter_refuses_a_tree_the_config_does_not_imply(jax_tree):
    with pytest.raises(ValueError, match="shape"):
        tweights.from_jax_params(
            jax_tree, TConfig(**dict(KW, vocab_size=256)), "cpu")
    bad = dict(jax_tree)
    del bad["word_embeddings"]
    with pytest.raises(KeyError, match="word_embeddings"):
        tweights.from_jax_params(bad, TConfig(**KW), "cpu")


def test_torch_init_has_the_jax_tree_shapes(jax_tree):
    cfg = TConfig(**KW)
    a = tweights.init_gpt_params(cfg, seed=5, device="cpu")
    b = tweights.init_gpt_params(cfg, seed=5, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    flat_a, flat_b = (jax.tree_util.tree_flatten_with_path(
        tweights.to_numpy_tree(t))[0] for t in (a, b))
    assert [(p, x.shape) for p, x in flat_j] \
        == [(p, x.shape) for p, x in flat_a]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        assert np.array_equal(x, y), f"seeded init not deterministic {path}"
    qkv = a["transformer"]["layer_0"]["self_attention"]
    assert abs(float(qkv["query_key_value"]["weight"].std()) - 0.02) < 4e-3
    assert abs(float(qkv["dense"]["weight"].std()) - 0.01) < 2e-3
    assert float(qkv["dense"]["bias"].abs().max()) == 0.0


def _pack():
    """Two packed requests + padding, as the engine stages them: rows 0/1
    of a 3-slot table, the spare all-null row 3 for padding."""
    rs = np.random.RandomState(7)
    lens = (11, 6)
    S = 24
    ids = np.zeros(S, np.int32)
    pos = np.zeros(S, np.int32)
    seg = np.zeros(S, np.int32)
    rows = np.full(S, 3, np.int32)
    cur = 0
    for r, n in enumerate(lens):
        ids[cur:cur + n] = rs.randint(0, KW["vocab_size"], n)
        pos[cur:cur + n] = np.arange(n)
        seg[cur:cur + n] = r + 1
        rows[cur:cur + n] = r
        cur += n
    pt = np.zeros((4, 4), np.int32)
    pt[0, :2] = (3, 7)
    pt[1, :2] = (5, 2)
    last = np.array([lens[0] - 1, lens[0] + lens[1] - 1, 0], np.int32)
    return lens, ids, pos, seg, rows, pt, last


@pytest.mark.parametrize("bf16,atol", [(False, 2e-4), (True, 0.35)],
                         ids=["f32", "bf16"])
def test_prefill_and_decode_logits_match_jax(jax_tree, bf16, atol):
    jcfg, tcfg = _cfgs(bf16)
    tparams = tweights.from_jax_params(jax_tree, tcfg, "cpu")
    lens, ids, pos, seg, rows, pt, last = _pack()
    n_pages = 10
    jcache = jkv.init_cache(2, 4, n_pages, PS, 16,
                            jmodel.compute_dtype(jcfg))
    tcache = tkv.init_cache(2, 4, n_pages, PS, 16,
                            tmodel.compute_dtype(tcfg))
    jcache, jlog = jmodel.prefill(
        jax_tree, jcache, *(jnp.asarray(x) for x in
                            (ids, pos, seg, rows, pt, last)), cfg=jcfg)
    tcache, tlog = tmodel.prefill(
        tparams, tcache, *(torch.from_numpy(x) for x in
                           (ids, pos, seg, rows, pt, last)), cfg=tcfg)
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jlog.astype(jnp.float32)),
                               atol=atol)
    # decode: slots 0 and 1 continue, slot 2 is inactive (length 0)
    toks = np.argmax(np.asarray(jlog.astype(jnp.float32)), -1).astype(
        np.int32)
    lengths = np.array([lens[0] + 1, lens[1] + 1, 0], np.int32)
    dpt = pt[:3]
    for step in range(3):
        jcache, jnext, jl = jmodel.decode_step(
            jax_tree, jcache, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(dpt), cfg=jcfg)
        tcache, tnext, tl = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(toks),
            torch.from_numpy(lengths), torch.from_numpy(dpt), cfg=tcfg)
        np.testing.assert_allclose(
            tl.float().numpy(), np.asarray(jl.astype(jnp.float32)),
            atol=atol, err_msg=f"decode step {step}")
        if not bf16:
            assert tnext.tolist() == np.asarray(jnext).tolist()
        assert tnext[2] == 0, "an inactive slot emits token 0"
        toks = np.array(jnext)
        lengths = lengths + (lengths > 0)
    # the paged cache holds the same K/V at the same (page, offset)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[name].float().numpy()[:, :, 1:],
            np.asarray(jcache[name].astype(jnp.float32))[:, :, 1:],
            atol=atol if bf16 else 1e-5)


def test_scatter_places_each_token_at_its_page_and_offset(jax_tree):
    """Token t of request r lands at cache[i, :, pt[r, t // ps], t % ps]
    with its heads on the head axis; padding touches only null page 0."""
    tcfg = TConfig(**KW)
    tparams = tweights.from_jax_params(jax_tree, tcfg, "cpu")
    lens, ids, pos, seg, rows, pt, last = _pack()
    cache = tkv.init_cache(2, 4, 10, PS, 16, torch.float32)
    seen = []

    def spy(q, k, v, **kw):
        seen.append(k[0].transpose(0, 1).clone())     # [S, H, d]
        return tmodel.fused_attention.__wrapped__(q, k, v, **kw) \
            if hasattr(tmodel.fused_attention, "__wrapped__") \
            else _plain(q, k, v, **kw)

    from apex_tpu_torch.ops import attention as tattn

    def _plain(q, k, v, **kw):
        return tattn.fused_attention(q, k, v, **kw)

    orig = tmodel.fused_attention
    tmodel.fused_attention = spy
    try:
        tmodel.prefill(tparams, cache, *(torch.from_numpy(x) for x in
                                         (ids, pos, seg, rows, pt, last)),
                       cfg=tcfg)
    finally:
        tmodel.fused_attention = orig
    cur = 0
    for r, n in enumerate(lens):
        for t in range(n):
            page, off = pt[r, t // PS], t % PS
            for layer in range(2):
                torch.testing.assert_close(cache["k"][layer, :, page, off],
                                           seen[layer][cur + t])
        cur += n
    live = {int(p) for p in pt[:2].ravel() if p}
    untouched = [p for p in range(1, 10) if p not in live]
    assert cache["k"][:, :, untouched].abs().max() == 0


def test_engine_matches_jax_token_for_token_fp32(jax_tree):
    jcfg, tcfg = _cfgs(False)
    jreqs, jid = jsched.synthetic_trace(**TRACE)
    treqs, tid = tsched.synthetic_trace(**TRACE)
    assert jid == tid
    je = JEngine(jcfg, jax_tree, **ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(jax_tree, tcfg, "cpu"),
                 device="cpu", **ENGINE)
    jdone = je.run_trace(jreqs)
    tdone = te.run_trace(treqs)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
        assert (b.admitted_tick, b.finished_tick) \
            == (a.admitted_tick, a.finished_tick)
    assert (te.prefill_batches, te.decode_steps, te.tokens_generated) \
        == (je.prefill_batches, je.decode_steps, je.tokens_generated)
    assert te.events.validate_order() == []
    assert te.allocator.free_count == ENGINE["num_pages"] - 1


def test_serving_config_takes_head_dim_80_and_refuses_past_256():
    """head_dim 80 (GPT-3 2.7B's), 264 (past the prefill kernels' 256:
    prefill takes the scores route) and 520 or 576 (past decode's 512:
    decode takes its scores route on the card) all serve; what the
    serving forward does not model is still refused before any forward."""
    base = dict(hidden_size=160, num_layers=1, num_attention_heads=2,
                vocab_size=64, max_position_embeddings=32, hidden_dropout=0.0,
                attention_dropout=0.0, apply_query_key_layer_scaling=False)
    tmodel.check_serving_config(TConfig(**base))
    assert TConfig(**base).head_dim == 80
    for d in (264, 512, 520, 576):
        tmodel.check_serving_config(TConfig(**dict(base, kv_channels=d)))
    with pytest.raises(ValueError, match="dropout"):
        tmodel.check_serving_config(TConfig(**dict(base, kv_channels=576,
                                                   hidden_dropout=0.1)))
    assert decode_attention_cuda.MAX_HEAD_DIM == 512


def test_engine_front_door_matches_jax():
    _, tcfg = _cfgs(False)
    te = TEngine(tcfg, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="prefill_len"):
        te.submit(tsched.Request(rid=0, prompt=[1] * 33, max_new_tokens=1))
    with pytest.raises(ValueError, match="per-slot table"):
        te.submit(tsched.Request(rid=1, prompt=[1] * 30, max_new_tokens=40))

    with pytest.raises(ValueError, match="sampling"):
        te.submit(tsched.Request(
            rid=2, prompt=[1, 2], max_new_tokens=2,
            sampling=tsampling.SamplingParams(temperature=0.7, seed=2)))
    assert not te.scheduler.queue


@pytest.mark.parametrize("policy", ["fifo", "priority"])
def test_scheduler_copy_admits_and_evicts_like_the_original(policy):
    log = []
    for sched_mod, kv_mod in ((jsched, jkv), (tsched, tkv)):
        alloc = kv_mod.PageAllocator(12)
        sch = sched_mod.ContinuousBatchingScheduler(3, 4, 4, alloc,
                                                    policy=policy)
        reqs = [sched_mod.Request(rid=i, prompt=[i] * (2 + 3 * (i % 4)),
                                  max_new_tokens=1 + (i * 5) % 7,
                                  priority=(i * 7) % 3)
                for i in range(10)]
        trace = []
        for tick in range(60):
            if tick in (0, 4):
                for r in reqs[:6] if tick == 0 else reqs[6:]:
                    sch.submit(r, tick=tick)
            ev = [r.rid for r in sch.evict_done(tick)]
            ad = sch.admit(tick)
            for i in sch.active_indices():
                sch.slots[i].pos += 1
                sch.slots[i].request.out_tokens.append(0)
            alloc.check_invariants()
            trace.append((ev, ad, [r.rid for i in ad
                                   for r in [sch.slots[i].request]],
                          sch.page_table_rows(), sch.decode_inputs()))
        assert len(sch.completed) == 10
        log.append(trace)
    assert log[0] == log[1]


def test_allocator_copy_matches_the_original():
    a, b = jkv.PageAllocator(16), tkv.PageAllocator(16)
    rs = np.random.RandomState(1)
    live = []
    for step in range(150):
        if live and rs.rand() < 0.4:
            victim = live.pop(int(rs.randint(len(live))))
            a.free(victim)
            b.free(victim)
        else:
            n = int(rs.randint(0, 5))
            got = a.alloc(step, n)
            assert b.alloc(step, n) == got
            if got is not None:
                live.append(step)
        b.check_invariants()
        assert a.live_pages() == b.live_pages()
        assert a.free_count == b.free_count
    assert tkv.pages_needed(17, 8) == jkv.pages_needed(17, 8) == 3


@pytest.mark.parametrize("kw", [
    {}, dict(arrival="diurnal", n_requests=40),
    dict(system_prompt=[5, 6, 7], mean_interarrival=0.0)])
def test_synthetic_trace_copy_matches_the_original(kw):
    a, aid = jsched.synthetic_trace(**kw)
    b, bid = tsched.synthetic_trace(**kw)
    assert aid == bid
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival) for r in a] \
        == [(r.rid, r.prompt, r.max_new_tokens, r.arrival) for r in b]
    assert tsched.offered_load(b) == jsched.offered_load(a)
    with pytest.raises(ValueError, match="arrival"):
        tsched.synthetic_trace(arrival="bursty")


def _warns_if(flag):
    return pytest.warns(UserWarning) if flag else contextlib.nullcontext()


def test_policy_and_env_knob_copies_match_the_originals(monkeypatch):
    for value in ("priority", "fifo", "bogus", ""):
        monkeypatch.setenv("APEX_SERVE_SCHED", value)
        with _warns_if(value == "bogus"):
            got = tsched.resolve_policy()
        assert got == jsched.resolve_policy()
    with pytest.raises(ValueError, match="policy"):
        tsched.resolve_policy("lifo")
    for value in ("12", "0", "x7", ""):
        monkeypatch.setenv("APEX_PORT_TEST_KNOB", value)
        with _warns_if(value in ("0", "x7")):
            got = _env.env_int("APEX_PORT_TEST_KNOB")
        assert got == jtiles.env_int("APEX_PORT_TEST_KNOB")


def test_lifecycle_copy_matches_the_original():
    reqs = []
    for i, (enq, first, fin, n) in enumerate(
            [(0.0, 0.5, 2.5, 5), (1.0, 1.25, None, 1), (2.0, None, None, 0),
             (0.5, 0.75, 4.75, 9)]):
        r = tsched.Request(rid=i, prompt=[1], max_new_tokens=max(n, 1))
        r.enqueue_wall, r.first_token_wall, r.finish_wall = enq, first, fin
        r.out_tokens = [0] * n
        reqs.append(r)
    assert tlife.request_latencies(reqs) == jlife.request_latencies(reqs)
    for q in (0, 50, 99, 100):
        vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6]
        assert tlife.percentile(vals, q) == jlife.percentile(vals, q)
    assert tlife.percentile([], 50) is None
    # one clean chain and three broken ones, judged alike
    tl, jl = tlife.EventLog(), jlife.EventLog()
    chains = {0: tlife.EVENTS,
              1: ("submitted", "first_token", "admitted"),
              2: ("submitted", "admitted", "finished"),
              3: ("submitted", "admitted", "admitted")}
    for rid, chain in chains.items():
        for tick, ev in enumerate(chain):
            tl.record(ev, rid, tick=tick, wall=float(tick))
            jl.record(ev, rid, tick=tick, wall=float(tick))
    assert tl.validate_order() == jl.validate_order()
    assert tl.validate_order(0) == []
    with pytest.raises(ValueError, match="unknown lifecycle event"):
        tl.record("teleported", 0)
