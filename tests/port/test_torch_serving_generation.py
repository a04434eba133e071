"""Port parity of serving's generation layers: speculative decode and the
prefix cache, ``apex_tpu_torch.serving`` against ``apex_tpu.serving``.

* The engines (fp32, one set of weights, one fake clock:
  ``serving_layers.py``) emit the same tokens at the same ticks and keep
  the same counters, rate accounts, event logs and gauges, with
  ``spec_decode`` 1, 2 and 4 (greedy, and mixed with sampled requests),
  the prefix cache under a shared system prompt (a pool small enough to
  reclaim, int8 KV pages, ``decode_k=4`` with the warm-token feed,
  composed with speculation and with sampling).
* ``speculative.propose`` / ``accept`` and ``PrefixCache``'s lookup,
  register, acquire, release and reclaim decisions match JAX's on
  hypothesis-drawn inputs, with the cache's invariants held after every
  operation; ``PageAllocator.transfer`` as JAX's.
* The knobs resolve as JAX's: a per-call argument is a demand (raises
  when it cannot be honored), an environment value a preference (garbage
  warns once and is ignored).
"""

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import prefix_cache as jprefix
from apex_tpu.serving import speculative as jspec
from apex_tpu_torch import _env
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import prefix_cache as tprefix
from apex_tpu_torch.serving import speculative as tspec
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

import serving_layers as sl

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_tree():
    return sl.jax_tree()


# --------------------------------------------------------- engine parity

SPEC_CASES = {
    "spec1": (sl.TRACE, False, dict(spec_decode=1)),
    "spec2": (sl.TRACE, False, dict(spec_decode=2)),
    "spec4": (sl.TRACE, False, dict(spec_decode=4)),
    "spec4_sampled": (sl.TRACE, True, dict(spec_decode=4, sampling=True)),
}
PREFIX_CASES = {
    "prefix_churn": (sl.SYSTEM_TRACE, False,
                     dict(prefix_cache=True, num_pages=14)),
    "prefix_int8": (sl.SYSTEM_TRACE, False,
                    dict(prefix_cache=True, kv_quant=True)),
    "prefix_k4_warm_feed": (sl.SYSTEM_TRACE, False,
                            dict(prefix_cache=True, decode_k=4)),
    "prefix_spec2": (sl.SYSTEM_TRACE, False,
                     dict(prefix_cache=True, spec_decode=2)),
    "prefix_sampled": (sl.SYSTEM_TRACE, True,
                       dict(prefix_cache=True, sampling=True)),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_decode_engine_matches_jax(jax_tree, monkeypatch, case):
    spec, sampled, kw = SPEC_CASES[case]
    drafted = []
    verify = TEngine._run_verify

    def recorded(self, drafts):
        drafted.extend(self.scheduler.slots[i].request for i, _ in drafts)
        return verify(self, drafts)

    monkeypatch.setattr(TEngine, "_run_verify", recorded)
    te, got = sl.parity(jax_tree, monkeypatch, spec, sampled=sampled, **kw)
    # the layer engaged, and stochastic slots never drafted
    assert te.verify_calls > 0 and te.spec_stats.drafted > 0
    assert te.generation_stats()["spec_acceptance_rate"] is not None
    assert drafted and all(r.sampling is None or r.sampling.greedy
                           for r in drafted)


@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_prefix_cache_engine_matches_jax(jax_tree, monkeypatch, case):
    spec, sampled, kw = PREFIX_CASES[case]
    reclaimed = []
    reclaim = tprefix.PrefixCache.reclaim

    def counted(self, n, protect=()):
        freed = reclaim(self, n, protect)
        reclaimed.append(freed)
        return freed

    monkeypatch.setattr(tprefix.PrefixCache, "reclaim", counted)
    te, got = sl.parity(jax_tree, monkeypatch, spec, sampled=sampled, **kw)
    assert te.generation_stats()["prefix_hit_rate"] > 0
    # every reference is released after the final evict
    assert all(n == 0 for n in te.prefix.refs.values())
    if case == "prefix_churn":
        assert sum(reclaimed) > 0, "the pool never ran short"


def test_spec_decode_gives_plain_greedy_tokens(jax_tree):
    """Speculative output is plain greedy decode's, token for token (fp32
    on the CPU), with fewer decode rounds."""
    cfg = TConfig(**sl.KW)
    from apex_tpu_torch.serving import weights as tweights
    from apex_tpu_torch.serving import scheduler as tsched

    params = tweights.from_jax_params(jax_tree, cfg, "cpu")
    out = {}
    for k in (None, 4):
        eng = TEngine(cfg, params, device="cpu", spec_decode=k, **sl.ENGINE)
        done = eng.run_trace(sl.trace(tsched, sl.TRACE))
        out[k] = ({r.rid: r.out_tokens for r in done}, eng.decode_steps)
    assert out[4][0] == out[None][0]
    assert out[4][1] < out[None][1]


# ------------------------------------------------------------ unit parity

@settings(max_examples=60, deadline=None)
@given(history=st.lists(st.integers(0, 3), min_size=0, max_size=24),
       k=st.integers(0, 6), ngram=st.integers(1, 3))
def test_propose_matches_jax(history, k, ngram):
    assert tspec.propose(history, k, ngram) \
        == jspec.propose(history, k, ngram)


@settings(max_examples=60, deadline=None)
@given(draft=st.lists(st.integers(0, 3), min_size=0, max_size=6),
       data=st.data())
def test_accept_matches_jax(draft, data):
    greedy = data.draw(st.lists(st.integers(0, 3), min_size=len(draft) + 1,
                                max_size=len(draft) + 1))
    got = tspec.accept(draft, greedy)
    assert got == jspec.accept(draft, greedy)
    assert 1 <= len(got) <= len(draft) + 1


def test_spec_stats_match_jax():
    t, j = tspec.SpecStats(), jspec.SpecStats()
    assert t.acceptance_rate() is None and t.mean_draft_len() is None
    for d, a in ((4, 2), (3, 3), (1, 0)):
        t.record(d, a)
        j.record(d, a)
    assert vars(t) == vars(j)
    assert (t.acceptance_rate(), t.mean_draft_len()) \
        == (j.acceptance_rate(), j.mean_draft_len())


def test_allocator_transfer_matches_jax():
    out = []
    for mod in (tkv, jkv):
        a = mod.PageAllocator(8)
        pages = a.alloc("r", 3)
        a.transfer("r", ("prefix", pages[0]), [pages[0]])
        with pytest.raises(ValueError, match="not owned"):
            a.transfer("r", "x", [pages[0]])
        a.transfer("r", "y", pages[1:])
        a.check_invariants()
        out.append((pages, sorted(a._owned.items(), key=repr), a._free))
    assert out[0] == out[1]


PS = 4
# prompts over a small alphabet sharing page-aligned prefixes
PREFIXES = [[1, 2, 3, 4], [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9, 9], [1, 2]]
op = st.one_of(
    st.tuples(st.just("register"), st.integers(0, 3),
              st.lists(st.integers(0, 3), max_size=7)),
    st.tuples(st.just("lookup"), st.integers(0, 3),
              st.lists(st.integers(0, 3), max_size=7)),
    st.tuples(st.just("release"), st.integers(0, 7)),
    st.tuples(st.just("reclaim"), st.integers(0, 5), st.booleans()))


def _state(cache):
    a = cache.allocator
    return (cache.nodes, cache.tails, cache.refs, cache._lru,
            cache.hit_tokens, cache.lookup_tokens, list(a._free),
            sorted(a._owned.items(), key=repr))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(op, min_size=1, max_size=25))
def test_prefix_cache_decisions_match_jax(ops):
    """The same operations on JAX's cache and the port's, each over its
    own allocator: the same returns, the same chains, tails, refcounts,
    LRU order and page accounting after every step, and the invariants
    hold throughout (churn: registering holders, hits taken by
    reference, releases, reclaim under protection)."""
    caches = [mod.PrefixCache(kv.PageAllocator(16), PS)
              for mod, kv in ((tprefix, tkv), (jprefix, jkv))]
    holders = [[], []]
    for n, o in enumerate(ops):
        results = []
        for c, held in zip(caches, holders):
            if o[0] in ("register", "lookup"):
                prompt = PREFIXES[o[1]] + o[2]
                shared, covered, tail = c.lookup(prompt)
                if o[0] == "lookup":
                    results.append((shared, covered, tail))
                    continue
                owner = ("req", n)
                need = -(-len(prompt) // PS) - len(shared)
                pages = c.allocator.alloc(owner, need)
                if pages is None:
                    c.reclaim(need - c.allocator.free_count,
                              protect=shared + ([tail[0]] if tail else []))
                    pages = c.allocator.alloc(owner, need)
                if pages is None:
                    results.append(None)
                    continue
                c.acquire(shared)
                c.count(len(prompt), covered)
                adopted, copies = c.register(prompt, shared + pages, owner)
                c.acquire(adopted)
                held.append((owner, shared + adopted))
                results.append((shared, covered, tail, adopted, copies))
            elif o[0] == "release":
                if held:
                    owner, pages = held.pop(o[1] % len(held))
                    c.release(pages)
                    c.allocator.free(owner)
                results.append(len(held))
            else:
                protect = list(c.refs)[:1] if o[2] else []
                results.append(c.reclaim(o[1], protect=protect))
            c.check_invariants()
            c.allocator.check_invariants()
        assert results[0] == results[1], o
        assert _state(caches[0]) == _state(caches[1]), o


def test_prefix_cache_flush_and_hash_match_jax():
    assert tprefix._page_hash(tprefix.ROOT, [1, 2, 3]) \
        == jprefix._page_hash(jprefix.ROOT, [1, 2, 3])
    for mod, kv in ((tprefix, tkv), (jprefix, jkv)):
        c = mod.PrefixCache(kv.PageAllocator(8), PS)
        pages = c.allocator.alloc("r", 2)
        adopted, copies = c.register([1, 2, 3, 4, 5, 6], pages, "r")
        assert adopted == pages[:1] and copies
        c.acquire(adopted)
        with pytest.raises(AssertionError, match="live references"):
            c.flush()
        c.release(adopted)
        assert c.flush() == 2 and not c.cached_pages()


# -------------------------------------------------------------------- knobs

def test_spec_and_prefix_knob_asymmetry(monkeypatch):
    for name in ("APEX_SPEC_DECODE", "APEX_SERVE_PREFIX_CACHE"):
        monkeypatch.delenv(name, raising=False)
    for bad in (0, -1, True, 1.5, "2"):
        with pytest.raises(ValueError, match="spec_decode="):
            tspec.resolve_k(bad)
        with pytest.raises(ValueError):
            jspec.resolve_k(bad)
    assert tspec.resolve_k() == jspec.resolve_k() == 0
    monkeypatch.setenv("APEX_SPEC_DECODE", "3")
    assert tspec.resolve_k() == 3 and tspec.resolve_k(2) == 2
    monkeypatch.setenv("APEX_SPEC_DECODE", "0")
    assert tspec.resolve_k() == 0
    _env._warned_env.clear()
    monkeypatch.setenv("APEX_SPEC_DECODE", "many")
    with pytest.warns(UserWarning, match="many"):
        assert tspec.resolve_k() == 0
    for bad in (1, "on"):
        with pytest.raises(ValueError, match="prefix_cache="):
            tprefix.resolve(bad)
        with pytest.raises(ValueError, match="set_prefix_cache"):
            tprefix.set_prefix_cache(bad)
    assert tprefix.resolve() is False
    monkeypatch.setenv("APEX_SERVE_PREFIX_CACHE", "1")
    assert tprefix.resolve() is True and tprefix.resolve(False) is False
    tprefix.set_prefix_cache(False)
    try:
        assert tprefix.resolve() is False, "the setter beats the env"
    finally:
        tprefix.set_prefix_cache(None)
    monkeypatch.setenv("APEX_SERVE_PREFIX_CACHE", "yes")
    with pytest.warns(UserWarning, match="yes"):
        assert tprefix.resolve() is False


def test_engine_spec_pairings_match_jax(monkeypatch):
    """A draft window past prefill_len raises as a demand and falls back
    as a preference; against decode_k, two demands raise, a demand drops
    the other side's preference, two preferences fall back to K = 1."""
    for name in ("APEX_SPEC_DECODE", "APEX_SERVE_DECODE_K"):
        monkeypatch.delenv(name, raising=False)
    cfg = TConfig(**sl.KW)
    kw = dict(sl.ENGINE, device="cpu")

    def build(**extra):
        return TEngine(cfg, **dict(kw, **extra))

    with pytest.raises(ValueError, match="verify window"):
        build(spec_decode=12, prefill_len=8)
    with pytest.raises(ValueError, match="two demands"):
        build(spec_decode=2, decode_k=4)
    monkeypatch.setenv("APEX_SPEC_DECODE", "12")
    assert build(prefill_len=8).spec_k == 0
    monkeypatch.setenv("APEX_SPEC_DECODE", "2")
    e = build(decode_k=4)
    assert (e.spec_k, e.decode_k, e.spec_stats) == (0, 4, None)
    monkeypatch.setenv("APEX_SERVE_DECODE_K", "4")
    e = build()
    assert (e.spec_k, e.decode_k, e._gather_w) == (2, 1, 3)
    monkeypatch.delenv("APEX_SPEC_DECODE")
    e = build(spec_decode=2)
    assert (e.spec_k, e.decode_k) == (2, 1)
