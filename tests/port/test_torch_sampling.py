"""Port parity of the serving sampler: ``apex_tpu_torch.serving.sampling``
against ``apex_tpu.serving.sampling`` and ``jax.random``.

* ``request_key`` is ``jax.random.PRNGKey(seed)``;
* the random bits of ``fold_in(key, counter)`` over V = 50304 are JAX's
  bit for bit, and the Gumbel noise is within 2 fp32 ulps (of the noise,
  or of 1 where the noise is smaller: the two packages' ``log`` differ by
  up to one ulp, and near g = 0 an ulp of the inner ``-log(u)`` is many
  ulps of g);
* ``sample_tokens`` gives JAX's tokens over a grid of temperatures, top-k,
  top-p and inactive lanes, at V = 32 and 50304;
* lanes are independent: equal rows under one (key, counter) draw one
  token, and a lane's draw does not depend on the batch around it (the
  property ``tests/test_serving_generation.py::
  test_sample_tokens_semantics`` meant to check; that test compares lanes
  over different logits rows);
* the ``sampling=`` / setter / ``APEX_SERVE_SAMPLING`` resolution, and a
  sampling-off engine refusing a stochastic request at submit.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving import sampling as jsampling
from apex_tpu_torch import _env
from apex_tpu_torch.serving import ServingEngine, Request
from apex_tpu_torch.serving import sampling as tsampling
from apex_tpu_torch.transformer.testing import TransformerConfig

torch.set_num_threads(2)

V_LARGE = 50304
SEEDS = (0, 7, 123456, 2 ** 31 - 1, -5)
KEY_COUNTERS = ((0, 0), (7, 3), (123456, 17), (2 ** 31 - 1, 999))
TEMPS = (0.0, 0.5, 1.0, 5.0)
TOP_KS = (0, 1, 5, 50)
TOP_PS = (1e-6, 0.9, 1.0)


def _jax_keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])


@pytest.mark.parametrize("seed", SEEDS)
def test_request_key_is_jax_prng_key(seed):
    key = tsampling.request_key(seed)
    assert key.dtype == np.uint32
    assert key.tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()


@pytest.mark.parametrize("seed,counter", KEY_COUNTERS)
def test_random_bits_equal_jax_bit_for_bit(seed, counter):
    key = np.asarray(jax.random.PRNGKey(seed))
    jkey = jax.random.fold_in(key, counter)
    k1, k2 = tsampling.fold_in(torch.from_numpy(key.astype(np.int64))[None],
                               torch.tensor([counter]))
    assert [int(k1), int(k2)] == np.asarray(jkey).tolist()
    want = np.asarray(jax.random.bits(jkey, (V_LARGE,), jnp.uint32))
    got = tsampling.random_bits(k1, k2, V_LARGE)[0].numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))

    jg = np.asarray(jax.random.gumbel(jkey, (V_LARGE,), jnp.float32))
    tg = tsampling.gumbel(torch.from_numpy(key.astype(np.int64))[None],
                          torch.tensor([counter]), V_LARGE)[0].numpy()
    assert tg.dtype == np.float32 and np.isfinite(tg).all()
    ulp = np.spacing(np.maximum(np.abs(jg), np.float32(1.0)))
    assert (np.abs(tg - jg) <= 2 * ulp).all(), np.abs(tg - jg).max()


def _grid_lanes():
    """Every (temperature, top_k, top_p) of the grid as one lane, then two
    inactive stochastic lanes."""
    combos = list(itertools.product(TEMPS, TOP_KS, TOP_PS))
    n = len(combos) + 2
    temps = np.array([c[0] for c in combos] + [0.8, 0.0], np.float32)
    top_ks = np.array([c[1] for c in combos] + [5, 0], np.int32)
    top_ps = np.array([c[2] for c in combos] + [0.9, 1.0], np.float32)
    keys = _jax_keys([100 + i for i in range(n)])
    counters = (np.arange(n) * 3).astype(np.int32)
    active = np.ones(n, bool)
    active[-2:] = False
    return temps, top_ks, top_ps, keys, counters, active


def _both(logits, temps, top_ks, top_ps, keys, counters, active):
    j = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), jnp.asarray(keys), jnp.asarray(counters),
        jnp.asarray(active)))
    t = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(counters),
        torch.from_numpy(active))
    assert t.dtype == torch.int32
    return j, t.numpy()


@pytest.mark.parametrize("vocab", [32, V_LARGE])
def test_sample_tokens_gives_jax_tokens_over_the_grid(vocab):
    lanes = _grid_lanes()
    rs = np.random.RandomState(vocab)
    logits = (rs.randn(len(lanes[0]), vocab) * 3).astype(np.float32)
    j, t = _both(logits, *lanes)
    np.testing.assert_array_equal(t, j)
    assert (t[-2:] == 0).all(), "inactive lanes give 0"
    greedy = lanes[0] == 0
    np.testing.assert_array_equal(t[greedy & lanes[5]],
                                  logits.argmax(-1)[greedy & lanes[5]])


def test_sample_tokens_bf16_logits_take_the_fp32_path():
    """bf16 logits are widened first (``logits.astype(f32)`` in JAX)."""
    lanes = _grid_lanes()
    rs = np.random.RandomState(1)
    logits = (rs.randn(len(lanes[0]), 64) * 3).astype(np.float32)
    logits = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    j, t = _both(logits, *lanes)
    np.testing.assert_array_equal(t, j)


def test_lanes_are_independent_on_equal_rows():
    """Four lanes over ONE logits row: equal (key, counter) draw equal
    tokens, each lane's draw equals its draw alone, and equals JAX's."""
    rs = np.random.RandomState(2)
    row = (rs.randn(1, V_LARGE) * 2).astype(np.float32)
    logits = np.repeat(row, 4, axis=0)
    temps = np.full(4, 1.0, np.float32)
    top_ks = np.zeros(4, np.int32)
    top_ps = np.ones(4, np.float32)
    keys = _jax_keys([7, 7, 8, 7])
    counters = np.array([0, 0, 0, 5], np.int32)
    active = np.ones(4, bool)
    j, t = _both(logits, temps, top_ks, top_ps, keys, counters, active)
    np.testing.assert_array_equal(t, j)
    assert t[0] == t[1]
    for i in range(4):
        _, alone = _both(logits[i:i + 1], temps[i:i + 1], top_ks[i:i + 1],
                         top_ps[i:i + 1], keys[i:i + 1], counters[i:i + 1],
                         active[i:i + 1])
        assert alone[0] == t[i]


def test_lane_arrays_match_the_originals():
    """The staging helpers fill the same lane values as JAX's."""
    class Req:
        def __init__(self, sampling, n_out):
            self.sampling, self.rng_key = sampling, None
            self.out_tokens = [0] * n_out

    class Slot:
        def __init__(self, request):
            self.request = request

    for mod in (jsampling, tsampling):
        reqs = [Req(mod.SamplingParams(0.8, 50, 0.95, seed=3), 4),
                Req(None, 2), Req(mod.SamplingParams(), 1)]
        slots = [Slot(reqs[0]), None, Slot(reqs[1]), Slot(reqs[2])]
        got = mod.lane_arrays(slots, 5)
        first = mod.batch_lanes(reqs)
        if mod is jsampling:
            want, want_first = got, first
    for a, b in zip(got + first, want + want_first):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()


def test_sampling_resolution_rules(monkeypatch):
    monkeypatch.delenv("APEX_SERVE_SAMPLING", raising=False)
    tsampling.set_sampling(None)
    assert tsampling.resolve() is False
    assert tsampling.resolve(True) is True
    for bad in (1, "1", 0.0):
        with pytest.raises(ValueError):
            tsampling.resolve(bad)
        with pytest.raises(ValueError):
            tsampling.set_sampling(bad)
    monkeypatch.setenv("APEX_SERVE_SAMPLING", "1")
    assert tsampling.resolve() is True
    assert tsampling.resolve(False) is False, "a demand beats the env"
    tsampling.set_sampling(False)
    try:
        assert tsampling.resolve() is False, "the setter beats the env"
    finally:
        tsampling.set_sampling(None)
    _env._warned_env.clear()
    monkeypatch.setenv("APEX_SERVE_SAMPLING", "yes")
    with pytest.warns(UserWarning, match="yes"):
        assert tsampling.resolve() is False


def test_a_sampling_off_engine_refuses_a_stochastic_request(monkeypatch):
    monkeypatch.delenv("APEX_SERVE_SAMPLING", raising=False)
    cfg = TransformerConfig(
        hidden_size=32, num_layers=1, num_attention_heads=2, vocab_size=64,
        max_position_embeddings=32, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False)
    kw = dict(num_slots=2, page_size=8, num_pages=8, max_seq=32,
              prefill_len=16, device="cpu")
    off = ServingEngine(cfg, **kw)
    hot = tsampling.SamplingParams(temperature=0.7, top_k=5, seed=9)
    with pytest.raises(ValueError, match="sampling"):
        off.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2,
                           sampling=hot))
    assert not off.scheduler.queue
    off.submit(Request(rid=1, prompt=[1, 2], max_new_tokens=2,
                       sampling=tsampling.GREEDY))
    with pytest.raises(ValueError, match="top_p"):
        off.submit(Request(rid=2, prompt=[1], max_new_tokens=1,
                           sampling=tsampling.SamplingParams(top_p=0.0)))
    on = ServingEngine(cfg, sampling=True, **kw)
    req = Request(rid=3, prompt=[1, 2], max_new_tokens=2, sampling=hot)
    on.submit(req)
    assert req.rng_key is None
    on.step()                       # the first token stages the lane
    assert req.rng_key.tolist() == [0, 9]
    with pytest.raises(ValueError, match="sampling="):
        ServingEngine(cfg, sampling=1, **kw)
