"""Port parity of int8 weight-quantized decode: ``apex_tpu_torch.serving.
quant`` and ``ops/qmatmul`` against ``apex_tpu.serving.quant`` on the same
numpy-seeded weights, and the fp32 engine with ``weight_quant=True``
against the JAX engine.

* ``quantize_weight`` gives JAX's codes and scales bit for bit (fp32 and
  bf16 weights, an all-zero row);
* ``qmatmul``'s plain version (K23's) matches JAX's ``qmatmul``: fp32
  within 1e-6 of the output's largest magnitude (the two sum in other
  orders), bf16 within one bf16 ulp of each output (2^-7 relative: a sum
  that lands near a rounding boundary of the final bf16 cast may round
  the other way);
* the knob resolves as ``tests/test_serving.py::test_quant_knob_asymmetry``
  pins it for JAX;
* the fp32 engine with ``weight_quant=True`` matches the JAX engine token
  for token, greedy and sampled, at K = 1 and K = 4, and its decode block
  matches JAX's logits;
* ``weight_quant=True`` raises on an int word table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import SamplingParams as JSampling
from apex_tpu.serving import model as jmodel
from apex_tpu.serving import quant as jquant
from apex_tpu.serving import scheduler as jsched
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch import _env
from apex_tpu_torch.ops import qmatmul as tqmm
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import model as tmodel
from apex_tpu_torch.serving import quant as tquant
from apex_tpu_torch.serving import sampling as tsampling
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

torch.set_num_threads(2)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
          attention_dropout=0.0, apply_query_key_layer_scaling=False)
ENGINE = dict(num_slots=3, page_size=8, num_pages=24, max_seq=64,
              prefill_len=32)
TRACE = dict(seed=7, n_requests=9, vocab=128, prompt_lo=3, prompt_hi=14,
             new_lo=2, new_hi=11)


def _weight(shape, seed, zero_rows=()):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    w[list(zero_rows)] = 0.0
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, 64), (7, 100), (129, 48)])
def test_quantize_weight_bit_for_bit(shape, dtype):
    w = _weight(shape, sum(shape), zero_rows=(3,))
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jquant.quantize_weight(jw)
    tq, ts = tquant.quantize_weight(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert ts[3].item() == 0.0 and (tq[3] == 0).all()


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 0.0, 1e-6),
                                             ("bfloat16", 2.0 ** -7, 0.0)])
@pytest.mark.parametrize("rows", [1, 8])
def test_qmatmul_plain_matches_jax(rows, dtype, rtol, atol):
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, 96).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(_weight((40, 96), 5, (2,))))
    cd = getattr(jnp, dtype)
    want = np.asarray(jquant.qmatmul(jnp.asarray(x), jq, js, cd).astype(
        jnp.float32))
    got = tqmm.qmatmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq)),
                       torch.from_numpy(np.asarray(js)),
                       getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, 40)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())
    assert (got[:, 2] == 0).all()


def test_quant_knob_asymmetry(monkeypatch):
    with pytest.raises(ValueError):
        tquant.quantize_weight(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tquant.set_weight_quant("yes")
    monkeypatch.setenv("APEX_SERVE_WEIGHT_QUANT", "1")
    assert tquant.resolve() is True
    monkeypatch.setenv("APEX_SERVE_WEIGHT_QUANT", "0")
    assert tquant.resolve() is False
    _env._warned_env.clear()
    monkeypatch.setenv("APEX_SERVE_WEIGHT_QUANT", "maybe")
    with pytest.warns(UserWarning, match="maybe"):
        assert tquant.resolve() is False
    monkeypatch.delenv("APEX_SERVE_WEIGHT_QUANT")
    tquant.set_weight_quant(True)
    try:
        assert tquant.resolve() is True
        assert tquant.resolve(per_call=False) is False
    finally:
        tquant.set_weight_quant(None)
    assert tquant.resolve() is False


@pytest.fixture(scope="module")
def jax_tree():
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_gpt_params(JConfig(**KW)))


def test_decode_params_and_block_match_jax(jax_tree):
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    tparams = tweights.from_jax_params(jax_tree, tcfg, "cpu")
    jqp = jmodel.quantize_decode_params(jax_tree, jcfg)
    tqp = tmodel.quantize_decode_params(tparams, tcfg)
    for jl, tl in zip(jqp["layers"] + [{"w": jqp["word_logits"]}],
                      tqp["layers"] + [{"w": tqp["word_logits"]}]):
        assert set(jl) == set(tl)
        for name in jl:
            np.testing.assert_array_equal(tl[name]["wq"].numpy(),
                                          np.asarray(jl[name]["wq"]))
            np.testing.assert_array_equal(tl[name]["scale"].numpy(),
                                          np.asarray(jl[name]["scale"]))
    # one decode step from an empty cache for three lanes (one inactive),
    # quantized in both packages
    from apex_tpu.serving import kv_cache as jkv
    from apex_tpu_torch.serving import kv_cache as tkv

    tokens = np.array([5, 17, 0], np.int32)
    lengths = np.array([1, 1, 0], np.int32)
    pt = np.array([[1, 0], [2, 0], [0, 0]], np.int32)
    jc = jkv.init_cache(2, 4, 6, 8, 16, jnp.float32)
    tc = tkv.init_cache(2, 4, 6, 8, 16, torch.float32)
    _, jtok, jlog = jmodel.decode_step(
        jax_tree, jc, *map(jnp.asarray, (tokens, lengths, pt)), cfg=jcfg,
        qparams=jqp)
    _, ttok, tlog = tmodel.decode_step(
        tparams, tc, *map(torch.from_numpy, (tokens, lengths, pt)),
        cfg=tcfg, qparams=tqp)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5)
    # the int8 path moves the logits, so the records were used
    _, _, flog = tmodel.decode_step(
        tparams, tkv.init_cache(2, 4, 6, 8, 16, torch.float32),
        *map(torch.from_numpy, (tokens, lengths, pt)), cfg=tcfg)
    assert (flog - tlog).abs().max().item() > 1e-5


def _trace(sched, sampling_cls, sampled):
    reqs, tid = sched.synthetic_trace(**TRACE)
    if sampled:
        for r in reqs:
            if r.rid % 2:
                r.sampling = sampling_cls(temperature=0.9, top_k=20,
                                          top_p=0.95, seed=r.rid)
    return reqs, tid


def _served(engine, reqs):
    return {r.rid: (list(r.out_tokens), r.admitted_tick, r.finished_tick)
            for r in engine.run_trace(reqs)}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("k", [1, 4])
def test_weight_quant_engine_matches_jax_token_for_token(jax_tree, k,
                                                         sampled):
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    jreqs, jid = _trace(jsched, JSampling, sampled)
    treqs, tid = _trace(tsched, tsampling.SamplingParams, sampled)
    assert jid == tid
    je = JEngine(jcfg, jax_tree, weight_quant=True, sampling=sampled,
                 decode_k=k, **ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(jax_tree, tcfg, "cpu"),
                 device="cpu", weight_quant=True, sampling=sampled,
                 decode_k=k, **ENGINE)
    assert te.weight_quant and te.qparams is not None
    assert te.qparams["layers"][0]["qkv"]["wq"].dtype == torch.int8
    want, got = _served(je, jreqs), _served(te, treqs)
    assert got == want
    assert (te.prefill_batches, te.decode_steps, te.tokens_generated) \
        == (je.prefill_batches, je.decode_steps, je.tokens_generated)


def test_weight_quant_off_by_default_and_raises_on_int_words(jax_tree,
                                                             monkeypatch):
    monkeypatch.delenv("APEX_SERVE_WEIGHT_QUANT", raising=False)
    tcfg = TConfig(**KW)
    params = tweights.from_jax_params(jax_tree, tcfg, "cpu")
    te = TEngine(tcfg, params, device="cpu", **ENGINE)
    assert not te.weight_quant and te.qparams is None
    bad = dict(params, word_embeddings=torch.zeros(
        params["word_embeddings"].shape, dtype=torch.int32))
    with pytest.raises(ValueError, match="weight_quant=True"):
        TEngine(tcfg, bad, device="cpu", weight_quant=True, **ENGINE)
    monkeypatch.setenv("APEX_SERVE_WEIGHT_QUANT", "1")
    assert TEngine(tcfg, params, device="cpu", **ENGINE).weight_quant
