"""Port parity of the int8 KV tier: ``apex_tpu_torch.serving.kv_tier``
against ``apex_tpu.serving.kv_tier`` on the same numpy inputs, decode
attention over int8 pages against the JAX reference and the JAX Pallas
kernel in interpret mode, and ``ServingEngine(kv_quant=True)`` against
the JAX engine with ``kv_quant=True`` on one weight tree and trace.

* The codec (``quantize``, ``dequantize``, ``inv_scale``, ``finite``,
  ``prefill_scatter_quant``, ``decode_scatter_quant``) gives JAX's codes
  and scales bit for bit: the same fp32 arithmetic, round half to even,
  clip after round, rows quantized under the fp32 grown scale and the
  scale stored in bf16.
* Decode attention over int8 pages: fp32 within 1e-5 of both JAX
  versions.
* The engines in fp32 at ``test_torch_serving.py``'s sizes: greedy
  tokens equal; every code within 1 of JAX's (the two packages' fp32
  matmuls differ by ulps, which moves a value sitting at a .5 code
  boundary), the scales within one bf16 ulp; page 0 all zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import decode_attention_pallas as dap
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import kv_tier as jtier
from apex_tpu.serving import model as jmodel
from apex_tpu.serving import scheduler as jsched
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch.ops import decode_attention as tda
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import kv_tier as ttier
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

torch.set_num_threads(2)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
          attention_dropout=0.0, apply_query_key_layer_scaling=False)
ENGINE = dict(num_slots=3, page_size=8, num_pages=24, max_seq=64,
              prefill_len=32)
TRACE = dict(seed=3, n_requests=10, vocab=128, prompt_lo=3, prompt_hi=14,
             new_lo=1, new_hi=12)


def _np(x):
    """A JAX or torch array as numpy, bf16 widened to fp32 exactly."""
    if torch.is_tensor(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same_bits(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _port_cache(jcache):
    """The port's cache dict from a JAX cache dict (numpy leaves)."""
    out = {}
    for k, v in jcache.items():
        v = np.asarray(v)
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _values(rs, shape, scale=3.0):
    x = (rs.randn(*shape) * scale).astype(np.float32)
    # values at .5 code steps and both non-finite kinds
    x.flat[::17] = np.round(x.flat[::17] * 2) / 2
    x.flat[5], x.flat[11] = np.nan, np.inf
    x.flat[23] = -np.inf
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_functions_match_jax_bit_for_bit(dtype):
    rs = np.random.RandomState(0)
    x = _values(rs, (2, 5, 4, 8))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _same_bits(ttier.finite(tx), jtier.finite(jx))
    amax = np.nanmax(np.abs(np.where(np.isfinite(x), x, 0)), axis=(-2, -1))
    scale = (amax / 127.0).astype(np.float32)
    # a dead page. (No subnormal scale: XLA on the CPU flushes
    # subnormals to zero, PyTorch does not, so a scale below 2^-126 —
    # an amax below ~1.5e-36 — would be a dead page in JAX only.)
    scale[0, 1] = 0.0
    js = jnp.asarray(scale, jnp.bfloat16)
    ts = torch.from_numpy(scale).to(torch.bfloat16)
    _same_bits(ttier.inv_scale(ts), jtier.inv_scale(js))
    _same_bits(ttier.inv_scale(torch.from_numpy(scale)),
               jtier.inv_scale(jnp.asarray(scale)))
    jq, tq = jtier.quantize(jx, js), ttier.quantize(tx, ts)
    assert tq.dtype == ttier.CODE_DTYPE == torch.int8
    _same_bits(tq, jq)
    assert (tq[0, 1] == 0).all()             # a dead scale gives zeros
    _same_bits(ttier.dequantize(tq, ts), jtier.dequantize(jq, js))
    _same_bits(ttier.dequantize(tq, ts, torch.bfloat16),
               jtier.dequantize(jq, js, jnp.bfloat16))


def test_constants_scales_and_cache_layout_match_jax():
    assert (ttier.QMAX, ttier.SCALE_KEYS, ttier.RESTORE_CHOICES) \
        == (jtier.QMAX, jtier.SCALE_KEYS, jtier.RESTORE_CHOICES)
    assert ttier.SCALE_DTYPE == torch.bfloat16
    jc = jkv.init_cache(2, 3, 5, 4, 8, kv_quant=True)
    tc = tkv.init_cache(2, 3, 5, 4, 8, kv_quant=True)
    assert set(tc) == set(jc)
    for k in jc:
        _same_bits(tc[k], jc[k])
    assert ttier.is_quantized(tc) and not ttier.is_quantized(
        tkv.init_cache(2, 3, 5, 4, 8))


def _prefill_case(seed):
    rs = np.random.RandomState(seed)
    L, h, P, ps, d = 2, 3, 7, 4, 8
    jcache = jax.tree_util.tree_map(
        np.asarray, jkv.init_cache(L, h, P, ps, d, kv_quant=True))
    # 6 live rows: 4 fill page 3, 2 start page 5; 3 padded rows on page 0
    dest_page = np.array([3, 3, 3, 3, 5, 5, 0, 0, 0], np.int64)
    dest_off = np.array([0, 1, 2, 3, 0, 1, 0, 0, 0], np.int64)
    return rs, jcache, dest_page, dest_off, (L, h, P, ps, d)


def _both_prefill(jcache, tcache, layer, part, val, dest_page, dest_off,
                  keep):
    jcache = jtier.prefill_scatter_quant(
        _jnp_cache(jcache), layer, part, jnp.asarray(val),
        jnp.asarray(dest_page, jnp.int32), jnp.asarray(dest_off, jnp.int32),
        jnp.asarray(keep))
    ttier.prefill_scatter_quant(
        tcache, layer, part, torch.from_numpy(val),
        torch.from_numpy(dest_page), torch.from_numpy(dest_off),
        torch.from_numpy(keep))
    return jax.tree_util.tree_map(np.asarray, jcache)


def _jnp_cache(jcache):
    return {k: jnp.asarray(v) for k, v in jcache.items()}


def _same_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for k in jcache:
        _same_bits(tcache[k], jcache[k])


def test_prefill_scatter_quant_matches_jax_bit_for_bit():
    rs, jcache, dest_page, dest_off, (L, h, P, ps, d) = _prefill_case(1)
    tcache = _port_cache(jcache)
    # page 2 already holds live rows (keep 1), pages 3 and 5 are fresh
    # (keep 0) and hold stale codes and scales that must die
    seed = _values(rs, (2, h, d))
    keep = np.zeros(P, np.float32)
    jcache = _both_prefill(jcache, tcache, 1, "k", seed,
                           np.array([2, 2], np.int64),
                           np.array([0, 1], np.int64), keep)
    jcache = _both_prefill(jcache, tcache, 1, "k", _values(rs, (2, h, d)),
                           np.array([3, 5], np.int64),
                           np.array([1, 2], np.int64), keep)
    _same_cache(tcache, jcache)
    keep = np.ones(P, np.float32)
    keep[[3, 5]] = 0.0
    for part in ("k", "v"):
        val = _values(rs, (len(dest_page), h, d), scale=5.0)
        jcache = _both_prefill(jcache, tcache, 1, part, val, dest_page,
                               dest_off, keep)
        _same_cache(tcache, jcache)
    v_rows = val
    # a second batch re-covers page 5 with keep 1 and larger rows: the
    # scale grows and the earlier codes re-quantize (ratio < 1)
    keep = np.ones(P, np.float32)
    val = _values(rs, (2, h, d), scale=20.0)
    jcache = _both_prefill(jcache, tcache, 1, "k", val,
                           np.array([5, 0], np.int64),
                           np.array([2, 0], np.int64), keep)
    _same_cache(tcache, jcache)
    for k in ("k", "v"):
        assert (tcache[k][:, :, 0] == 0).all(), "page 0 must stay zero"
        assert (tcache[k + "_scale"][:, :, 0] == 0).all()
    assert (tcache["k"][0] == 0).all(), "layer 0 was never written"
    # the v rows landed within one code step of their finite values
    got = ttier.dequantize(tcache["v"][1], tcache["v_scale"][1])
    band = tcache["v_scale"][1].float() * 1.0 + 1e-6
    want = ttier.finite(torch.from_numpy(v_rows))
    for r, (p, o) in enumerate(zip(dest_page[:6], dest_off[:6])):
        err = (got[:, p, o] - want[r]).abs()
        assert (err <= band[:, p, None]).all(), (r, float(err.max()))


def test_decode_scatter_quant_matches_jax_bit_for_bit():
    rs, jcache, _, _, (L, h, P, ps, d) = _prefill_case(2)
    tcache = _port_cache(jcache)
    keep = np.zeros(P, np.float32)
    for part in ("k", "v"):
        jcache = _both_prefill(jcache, tcache, 0, part,
                               _values(rs, (3, h, d)),
                               np.array([4, 4, 4], np.int64),
                               np.array([0, 1, 2], np.int64), keep)
        # page 6 holds stale content from an earlier owner
        jcache = _both_prefill(jcache, tcache, 0, part,
                               _values(rs, (4, h, d)),
                               np.array([6, 6, 6, 6], np.int64),
                               np.arange(4, dtype=np.int64), keep)
    # four lanes: one appends at offset 3 of page 4, one takes fresh page
    # 6 at offset 0 (its stale rows must die), two are inactive (page 0)
    write_page = np.array([4, 0, 6, 0], np.int64)
    write_off = np.array([3, 0, 0, 0], np.int64)
    for step in range(2):
        for part in ("k", "v"):
            val = _values(rs, (4, h, d))
            jcache = jax.tree_util.tree_map(np.asarray, jtier.decode_scatter_quant(
                _jnp_cache(jcache), 0, part, jnp.asarray(val),
                jnp.asarray(write_page, jnp.int32),
                jnp.asarray(write_off, jnp.int32)))
            ttier.decode_scatter_quant(tcache, 0, part, torch.from_numpy(val),
                                       torch.from_numpy(write_page),
                                       torch.from_numpy(write_off))
            _same_cache(tcache, jcache)
        write_off = write_off + np.array([0, 0, 1, 0])
        write_page[0] = 5                          # lane 0 moves to page 5
        write_off[0] = 0
    for k in ("k", "v"):
        assert (tcache[k][:, :, 0] == 0).all(), "page 0 must stay zero"
        assert (tcache[k + "_scale"][:, :, 0] == 0).all()
        # page 6's stale rows past the two written ones died
        assert (tcache[k][0, :, 6, 2:] == 0).all()


def test_scatters_with_duplicate_page0_rows_are_order_free():
    """All duplicate scatter indices are page 0 rows, and all of them
    write exact zeros: reversing the row order changes nothing."""
    rs, jcache, dest_page, dest_off, (L, h, P, ps, d) = _prefill_case(3)
    keep = np.zeros(P, np.float32)
    val = _values(rs, (len(dest_page), h, d))
    a, b = _port_cache(jcache), _port_cache(jcache)
    ttier.prefill_scatter_quant(a, 0, "k", torch.from_numpy(val),
                                torch.from_numpy(dest_page),
                                torch.from_numpy(dest_off),
                                torch.from_numpy(keep))
    rev = slice(None, None, -1)
    ttier.prefill_scatter_quant(
        b, 0, "k", torch.from_numpy(val[rev].copy()),
        torch.from_numpy(dest_page[rev].copy()),
        torch.from_numpy(dest_off[rev].copy()), torch.from_numpy(keep))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert (a["k"][:, :, 0] == 0).all()


def _attn_data(seed=3, dtype=np.float32, D=64):
    B, H, P, PS, MAXP = 4, 4, 16, 32, 4
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, D).astype(dtype)
    kf = rs.randn(H, P, PS, D).astype(np.float32)
    vf = rs.randn(H, P, PS, D).astype(np.float32)
    kf[:, 0] = vf[:, 0] = 0.0
    ks = jnp.asarray(np.abs(kf).max(axis=(-2, -1)) / 127.0, jnp.bfloat16)
    vs = jnp.asarray(np.abs(vf).max(axis=(-2, -1)) / 127.0, jnp.bfloat16)
    k8 = np.asarray(jtier.quantize(jnp.asarray(kf), ks))
    v8 = np.asarray(jtier.quantize(jnp.asarray(vf), vs))
    pt = np.stack([rs.permutation(np.arange(1, P))[:MAXP]
                   for _ in range(B)]).astype(np.int32)
    lens = np.array([5, PS, MAXP * PS, 0], np.int32)
    return q, k8, v8, np.asarray(ks), np.asarray(vs), pt, lens, D ** -0.5


def _t(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("d", [64, 32, 80, 256, 512])
def test_decode_attention_over_int8_pages_matches_jax(d):
    q, k8, v8, ks, vs, pt, lens, sm = _attn_data(D=d)
    args = [jnp.asarray(x) for x in (q, k8, v8, pt, lens)]
    jref = dap.decode_attention_reference(*args, sm, k_scale=jnp.asarray(ks),
                                          v_scale=jnp.asarray(vs))
    jpallas = dap.decode_attention_pallas(
        *args, sm, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        interpret=True)
    got = tda.decode_attention(_t(q), _t(k8), _t(v8), _t(pt), _t(lens),
                               sm_scale=sm, k_scale=_t(ks), v_scale=_t(vs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpallas), atol=1e-5,
                               rtol=0)
    assert (got[3] == 0).all(), "a slot of length 0 gives 0"
    # the same function as attention over the dequantized pages
    deq = [ttier.dequantize(_t(c), _t(s)) for c, s in ((k8, ks), (v8, vs))]
    plain = tda.decode_attention_reference(_t(q), *deq, _t(pt), _t(lens), sm)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=0)


def test_decode_attention_argument_checks_raise_as_jax():
    q, k8, v8, ks, vs, pt, lens, sm = _attn_data()
    targs = [_t(x) for x in (q, k8, v8, pt, lens)]
    jargs = [jnp.asarray(x) for x in (q, k8, v8, pt, lens)]
    for mod, args, scale in ((dap, jargs, jnp.asarray(ks)),
                             (tda, targs, _t(ks))):
        with pytest.raises(ValueError, match="come as a pair"):
            mod.decode_attention(*args, sm_scale=sm, k_scale=scale)
        with pytest.raises(ValueError, match="come as a pair"):
            mod.decode_attention(*args, sm_scale=sm, v_scale=scale)
        with pytest.raises(ValueError, match="int8 pages without"):
            mod.decode_attention(*args, sm_scale=sm)


def _jax_cache_numpy(jcache):
    return jax.tree_util.tree_map(np.asarray, jcache)


def test_engine_kv_quant_matches_jax_token_for_token_fp32():
    jax_tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_gpt_params(JConfig(**KW)))
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    jreqs, jid = jsched.synthetic_trace(**TRACE)
    treqs, tid = tsched.synthetic_trace(**TRACE)
    assert jid == tid
    je = JEngine(jcfg, jax_tree, kv_quant=True, **ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(jax_tree, tcfg, "cpu"),
                 device="cpu", kv_quant=True, **ENGINE)
    assert te.kv_quant and ttier.is_quantized(te.cache)
    assert te.cache["k"].dtype == torch.int8
    assert te.kv_tier_rates() == je.kv_tier_rates() == {
        "kv_quant": True, "swap_rate": None,
        "swapped_pages_high_water": None}
    jdone = je.run_trace(jreqs)
    tdone = te.run_trace(treqs)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
    assert (te.prefill_batches, te.decode_steps, te.tokens_generated) \
        == (je.prefill_batches, je.decode_steps, je.tokens_generated)
    jc = _jax_cache_numpy(je.cache)
    assert set(te.cache) == set(jc)
    n_codes = n_diff = 0
    for k in ("k", "v"):
        diff = np.abs(te.cache[k].numpy().astype(np.int32)
                      - jc[k].astype(np.int32))
        assert diff.max() <= 1, (k, int(diff.max()))
        n_codes += diff.size
        n_diff += int((diff > 0).sum())
        ts = te.cache[k + "_scale"].float().numpy()
        js = jc[k + "_scale"].astype(np.float32)
        # one bf16 ulp (2^-8 relative) where the amax moved by ulps
        np.testing.assert_allclose(ts, js, rtol=2 ** -7, atol=0)
        assert (te.cache[k][:, :, 0] == 0).all(), "page 0 must stay zero"
        assert (te.cache[k + "_scale"][:, :, 0] == 0).all()
    # codes that differ at all are rare: fp32 ulps only move a value that
    # sits at a .5 code boundary (measured here: 0 of 49,152)
    print(f"int8 codes differing from JAX's by 1: {n_diff} of {n_codes}")
    assert n_diff <= n_codes // 1000, (n_diff, n_codes)


def test_engine_kv_quant_resolves_like_jax_and_refuses_swap(monkeypatch):
    tcfg = TConfig(**KW)
    small = dict(ENGINE, num_pages=8)
    monkeypatch.setenv("APEX_SERVE_KV_QUANT", "1")
    assert ttier.resolve_kv_quant() is jtier.resolve_kv_quant() is True
    assert TEngine(tcfg, device="cpu", **small).kv_quant
    assert not TEngine(tcfg, device="cpu", kv_quant=False, **small).kv_quant
    monkeypatch.setenv("APEX_SERVE_KV_QUANT", "0")
    assert ttier.resolve_kv_quant() is jtier.resolve_kv_quant() is False
    assert ttier.resolve_kv_quant(True) is jtier.resolve_kv_quant(True)
    monkeypatch.delenv("APEX_SERVE_KV_QUANT")
    eng = TEngine(tcfg, device="cpu", **small)
    assert not eng.kv_quant and eng.cache["k"].dtype == torch.float32
    assert eng.kv_tier_rates()["kv_quant"] is None
    with pytest.raises(ValueError, match="kv_swap=True"):
        TEngine(tcfg, device="cpu", kv_swap=True, **small)
    with pytest.raises(ValueError, match="kv_restore='swap'"):
        TEngine(tcfg, device="cpu", kv_restore="swap", **small)
    with pytest.raises(ValueError, match="unknown kv_restore"):
        TEngine(tcfg, device="cpu", kv_restore="page", **small)
    assert TEngine(tcfg, device="cpu", kv_restore="recompute",
                   **small).kv_quant is False


def test_quantized_prefill_needs_keep_scale():
    from apex_tpu_torch.serving import model as tmodel

    tcfg = TConfig(**KW)
    params = tweights.init_gpt_params(tcfg, 0, "cpu")
    cache = tkv.init_cache(2, 4, 6, 8, 16, kv_quant=True)
    z = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="keep_scale"):
        tmodel.prefill(params, cache, z, z, z, z,
                       torch.zeros(1, 2, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.long), cfg=tcfg)
