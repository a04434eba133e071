"""Port parity of the K-step decode block and the sampling engine:
``apex_tpu_torch.serving`` against ``apex_tpu.serving`` on one set of
weights (the JAX GPTModel init, carried across by from_jax_params), fp32.

* ``model.decode_block`` matches JAX's at K = 1, 2 and 4, greedy and with
  sampling lanes, with ballast lanes (budget 0 and budgets under K), an
  inactive slot and a nonzero warm-token feed;
* the engine with sampling on matches the JAX engine token for token at
  K = 1 and 4 over a seeded trace of mixed greedy and sampled requests
  (ticks, dispatch counts and tokens), and K = 4 gives K = 1's tokens;
* ``resolve_decode_k`` and ``cuda_graph=`` resolve as stated (True on the
  CPU raises; None is eager on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import SamplingParams as JSampling
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import model as jmodel
from apex_tpu.serving import scheduler as jsched
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch import _env
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import engine as tengine
from apex_tpu_torch.serving import kv_cache as tkv
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
TRACE = dict(seed=5, n_requests=9, vocab=128, prompt_lo=3, prompt_hi=14,
             new_lo=2, new_hi=11)


@pytest.fixture(scope="module")
def jax_tree():
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_gpt_params(JConfig(**KW)))


def _prefilled(jax_tree):
    """Both packages' caches after one packed prefill of three requests
    into slots 0-2, the first tokens, lengths and the page table."""
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    tparams = tweights.from_jax_params(jax_tree, tcfg, "cpu")
    rs = np.random.RandomState(11)
    lens = (9, 5, 12)
    S = 32
    ids, pos, seg = (np.zeros(S, np.int32) for _ in range(3))
    rows = np.full(S, 3, np.int32)
    pt = np.zeros((4, 4), np.int32)
    pt[0, :3] = (3, 7, 9)
    pt[1, :3] = (5, 2, 10)
    pt[2, :3] = (4, 6, 11)
    cur = 0
    for r, n in enumerate(lens):
        ids[cur:cur + n] = rs.randint(0, KW["vocab_size"], n)
        pos[cur:cur + n] = np.arange(n)
        seg[cur:cur + n] = r + 1
        rows[cur:cur + n] = r
        cur += n
    last = np.cumsum(lens).astype(np.int32) - 1
    jc = jkv.init_cache(2, 4, 12, PS, 16, jnp.float32)
    tc = tkv.init_cache(2, 4, 12, PS, 16, torch.float32)
    args = (ids, pos, seg, rows, pt, last)
    jc, jl = jmodel.prefill(jax_tree, jc, *map(jnp.asarray, args), cfg=jcfg)
    tc, _ = tmodel.prefill(tparams, tc, *map(torch.from_numpy, args),
                           cfg=tcfg)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    # slot 3 is inactive (length 0)
    tokens = np.append(first, 0).astype(np.int32)
    lengths = np.array([lens[0] + 1, lens[1] + 1, lens[2] + 1, 0], np.int32)
    dpt = np.concatenate([pt[:3], np.zeros((1, 4), np.int32)])
    return (jcfg, tcfg, tparams, jc, tc, tokens, lengths, dpt)


def _lanes(sampled):
    temps = np.array([0.9, 0.0, 1.3, 0.7] if sampled else [0.0] * 4,
                     np.float32)
    top_ks = np.array([0, 0, 20, 3], np.int32)
    top_ps = np.array([0.9, 1.0, 1.0, 0.5], np.float32)
    keys = np.stack([tsampling.request_key(40 + i) for i in range(4)])
    counters = np.array([1, 1, 4, 0], np.int32)
    return temps, top_ks, top_ps, keys, counters


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "lanes"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_decode_block_matches_jax(jax_tree, k, sampled):
    (jcfg, tcfg, tparams, jc, tc, tokens, lengths,
     pt) = _prefilled(jax_tree)
    # slot 0 runs the whole block; slot 1 is ballast (budget 0); slot 2
    # stops after one step and takes one warm token first; slot 3 is
    # inactive
    budget = np.array([k, 0, 1, k], np.int32)
    warm_steps = np.array([0, 0, min(1, k - 1), 0], np.int32)
    warm_tokens = np.zeros((k, 4), np.int32)
    warm_tokens[0, 2] = 77
    lanes = _lanes(sampled)
    jc, jtoks, jlog = jmodel.decode_block(
        jax_tree, jc, *map(jnp.asarray, (tokens, lengths, pt, budget,
                                         warm_tokens, warm_steps)),
        lanes=tuple(map(jnp.asarray, lanes)) if sampled else None,
        k=k, cfg=jcfg)
    tlanes = tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                    else a) for a in lanes)
    tc, ttoks, tlog = tmodel.decode_block(
        tparams, tc, *map(torch.from_numpy, (tokens, lengths, pt, budget,
                                             warm_tokens, warm_steps)),
        tlanes if sampled else None, k=k, cfg=tcfg)
    assert ttoks.dtype == torch.int32 and tuple(ttoks.shape) == (k, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-4)
    assert (ttoks[:, 1] == 0).all() and (ttoks[:, 3] == 0).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[:, :, 1:],
                                   np.asarray(jc[name])[:, :, 1:],
                                   atol=1e-5)


def _trace(sched, sampling_cls):
    reqs, tid = sched.synthetic_trace(**TRACE)
    for r in reqs:
        if r.rid % 3 == 1:
            r.sampling = sampling_cls(temperature=0.8, top_k=20, top_p=0.95,
                                      seed=r.rid)
        elif r.rid % 3 == 2:
            r.sampling = sampling_cls(temperature=1.5, seed=1000 + r.rid)
    return reqs, tid


def _served(engine, reqs):
    done = engine.run_trace(reqs)
    return {r.rid: (list(r.out_tokens), r.admitted_tick, r.finished_tick)
            for r in done}


@pytest.mark.parametrize("k", [1, 4])
def test_sampling_engine_matches_jax_token_for_token(jax_tree, k):
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    jreqs, jid = _trace(jsched, JSampling)
    treqs, tid = _trace(tsched, tsampling.SamplingParams)
    assert jid == tid
    je = JEngine(jcfg, jax_tree, sampling=True, decode_k=k, **ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(jax_tree, tcfg, "cpu"),
                 device="cpu", sampling=True, decode_k=k, **ENGINE)
    assert te.sampling and te.decode_k == k and te._graph is None
    want, got = _served(je, jreqs), _served(te, treqs)
    assert got == want
    assert (te.prefill_batches, te.decode_steps, te.tokens_generated) \
        == (je.prefill_batches, je.decode_steps, je.tokens_generated)
    assert te.events.validate_order() == []
    assert te.allocator.free_count == ENGINE["num_pages"] - 1


def test_k4_gives_the_k1_tokens_with_fewer_dispatches(jax_tree):
    tcfg = TConfig(**KW)
    params = tweights.from_jax_params(jax_tree, tcfg, "cpu")
    out = {}
    for k in (1, 4):
        te = TEngine(tcfg, params, device="cpu", sampling=True, decode_k=k,
                     **ENGINE)
        reqs, _ = _trace(tsched, tsampling.SamplingParams)
        out[k] = ({rid: v[0] for rid, v in _served(te, reqs).items()},
                  te.decode_steps, te.tokens_generated)
    assert out[4][0] == out[1][0]
    assert out[4][2] == out[1][2]
    assert out[4][1] < out[1][1]


def test_resolve_decode_k(monkeypatch):
    monkeypatch.delenv("APEX_SERVE_DECODE_K", raising=False)
    for bad in (True, False, 0, -1, 1.5, "4"):
        with pytest.raises(ValueError):
            tmodel.resolve_decode_k(bad)
    assert tmodel.resolve_decode_k(4) == 4
    assert tmodel.resolve_decode_k() == 1
    monkeypatch.setenv("APEX_SERVE_DECODE_K", "4")
    assert tmodel.resolve_decode_k() == 4
    assert tmodel.resolve_decode_k(2) == 2, "a demand beats the env"
    _env._warned_env.clear()
    monkeypatch.setenv("APEX_SERVE_DECODE_K", "fast")
    with pytest.warns(UserWarning, match="fast"):
        assert tmodel.resolve_decode_k() == 1


def test_cuda_graph_resolution_on_the_cpu():
    cpu = torch.device("cpu")
    assert tengine.resolve_cuda_graph(None, cpu) is False
    assert tengine.resolve_cuda_graph(False, cpu) is False
    assert tengine.resolve_cuda_graph(None, torch.device("cuda")) is True
    with pytest.raises(ValueError, match="CUDA"):
        tengine.resolve_cuda_graph(True, cpu)
    with pytest.raises(ValueError, match="cuda_graph="):
        tengine.resolve_cuda_graph(1, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        TEngine(TConfig(**KW), device="cpu", cuda_graph=True, **ENGINE)
