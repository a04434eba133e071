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
* ``weight_quant=True`` raises on an int word table;
* K23's launch plan (``ops/qmatmul_cuda.plan``, CPU only: no kernel
  runs): fp32 on the CUDA-core body, the plans the C entry refuses
  refused by the wrapper's check, and, through ``_grid`` and ``_pieces``
  (this file's copies of ``csrc/qmatmul.cu``'s ``launch_tc`` grid and
  ``piece_of``; the card tests hold the kernel itself), every piece of K
  covered once, every output channel and x row by one warp, grids within
  CUDA's limits up to ``MAX_ROWS`` rows and N = 50304.
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
from apex_tpu_torch.ops import qmatmul_cuda
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


@pytest.mark.parametrize("k", [1, 4])
def test_weight_quant_engine_at_hidden_100_matches_jax(k):
    """K23 takes any K: at hidden 100 every decode matrix has K = 100 or
    400, none a multiple of 64 and the first not of 16."""
    kw = dict(KW, hidden_size=100)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init_gpt_params(jcfg))
    jreqs, _ = _trace(jsched, JSampling, False)
    treqs, _ = _trace(tsched, tsampling.SamplingParams, False)
    je = JEngine(jcfg, tree, weight_quant=True, decode_k=k, **ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(tree, tcfg, "cpu"),
                 device="cpu", weight_quant=True, decode_k=k, **ENGINE)
    assert te.qparams["layers"][0]["qkv"]["wq"].shape[1] == 100
    assert _served(te, treqs) == _served(je, jreqs)


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


# ------------------------------------------------------------- K23's plan

# [B, K, N]: GPT-2-small's decode shapes at 8 slots, the card tests'
# edges, one row and the most rows at the widest N
PLAN_SHAPES = [(8, 768, 2304), (8, 768, 768), (8, 768, 3072), (8, 3072, 768),
               (8, 768, 50304), (1, 768, 768), (3, 16, 100), (9, 528, 33),
               (17, 1040, 70), (16, 64, 32), (5, 4096, 4000), (8, 80, 48),
               (9, 784, 2310), (17, 816, 770), (40, 272, 130),
               (1, 12288, 50304), (qmatmul_cuda.MAX_ROWS, 768, 50304)]
HALF = [torch.bfloat16, torch.float16]
SM = 132


def _tc_plans(B, K):
    """Every tensor-core plan the C entry takes at [B, K] with the fewest
    n-tiles, and with the most, at each depth."""
    most = max(1, K // qmatmul_cuda.CHUNK)
    nts = sorted({min(4, -(-B // 8)), 4})
    return [qmatmul_cuda.Plan("tc", nt, s, c, d) for nt in nts
            for s in qmatmul_cuda.SPLITS for c in range(1, 9) if s * c <= most
            for d in sorted({2, qmatmul_cuda.max_depth(nt)})]


def _grid(p, B, N):
    """``(x, y, z)`` blocks of plan ``p``'s launch (128 threads each; the
    C entry's): tc over channel tiles, the cluster's blocks, row groups;
    simt over 16-channel blocks and 8-row groups."""
    if p.body == "simt":
        return -(-N // 16), -(-B // 8), 1
    tiles, per = -(-N // 16), 4 // p.split
    return -(-tiles // per), p.cluster, -(-B // (8 * p.nt))


def _pieces(p, K):
    """The ``[start, end)`` columns of K that each of plan ``p``'s pieces
    sums (the kernel's ``piece_of``): piece ``rank * split + s`` of the
    ``split * cluster``, whole 64-column chunks in equal shares, the
    16-column steps past the last chunk to the last piece."""
    n, n64 = p.split * p.cluster, K // 64
    return [(i * n64 // n * 64, K if i == n - 1 else (i + 1) * n64 // n * 64)
            for i in range(n)]


def _covers(p, B, N):
    """How many warps write each output channel, and each x row, under
    plan ``p`` (the kernels' index maps)."""
    gx, gy, gz = _grid(p, B, N)
    chans, rows = np.zeros(N, int), np.zeros(B, int)
    if p.body == "simt":
        for bx in range(gx):
            for warp in range(4):
                n0 = bx * 16 + warp * 4
                chans[n0:min(n0 + 4, N)] += 1
        rows_per, groups = 8, gy
    else:
        per = 4 // p.split
        for bx in range(gx):
            for r in range(per):
                n0 = (bx * per + r) * 16
                chans[n0:min(n0 + 16, N)] += 1
        rows_per, groups = 8 * p.nt, gz
    for z in range(groups):
        rows[z * rows_per:min((z + 1) * rows_per, B)] += 1
    return chans, rows


@pytest.mark.parametrize("K", [16, 48, 64, 80, 528, 768, 784, 816, 1040,
                               3072, 4096, 12288])
def test_qmatmul_plan_pieces_cover_k_once(K):
    for p in _tc_plans(8, K) + [qmatmul_cuda.plan(8, 768, K, d, SM)
                                for d in HALF]:
        cuts = _pieces(p, K)
        assert len(cuts) == p.split * p.cluster
        assert cuts[0][0] == 0 and cuts[-1][1] == K, (p, cuts)
        for (lo, hi), (nxt, _) in zip(cuts, cuts[1:]):
            assert hi == nxt, (p, cuts)            # no gap, no overlap
        for lo, hi in cuts:
            assert lo < hi and lo % 64 == 0 and hi % 16 == 0, (p, cuts)
            assert hi % 64 == 0 or hi == K, (p, cuts)


@pytest.mark.parametrize("dtype", HALF + [torch.float32],
                         ids=lambda d: str(d).replace("torch.", ""))
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_qmatmul_plan_covers_outputs_within_grid_limits(shape, dtype):
    B, K, N = shape
    p = qmatmul_cuda.plan(B, N, K, dtype, SM)
    assert p.body == ("simt" if dtype == torch.float32 else "tc")
    qmatmul_cuda.check_plan(p, B, K, dtype)
    plans = [p] + (_tc_plans(B, K) if p.body == "tc" else [])
    for q in plans:
        gx, gy, gz = _grid(q, B, N)
        assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535 and 1 <= gz <= 65535
        if q.body == "tc":
            assert gy == q.cluster and q.cluster <= 8
        if B * N <= 10 ** 6:
            chans, rows = _covers(q, B, N)
            assert (chans == 1).all() and (rows == 1).all(), q
        else:                                 # counted, not enumerated
            per, rows_per = ((4 // q.split) * 16, 8 * q.nt) \
                if q.body == "tc" else (16, 8)
            groups = gz if q.body == "tc" else gy
            assert (gx - 1) * per < N <= gx * per, q
            assert (groups - 1) * rows_per < B <= groups * rows_per, q


@pytest.mark.parametrize("shape", [(8, 768, 768), (1, 64, 16), (40, 80, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_qmatmul_plan_fp32_takes_the_cuda_core_body(shape):
    B, K, N = shape
    assert qmatmul_cuda.plan(B, N, K, torch.float32, SM) == \
        qmatmul_cuda.Plan("simt", 1, 1, 1, 1)
    for d in HALF:
        assert qmatmul_cuda.plan(B, N, K, d, SM).body == "tc"
    with pytest.raises(ValueError):
        qmatmul_cuda.plan(B, N, K, torch.int8, SM)


@pytest.mark.parametrize("case", [
    ("simt", 1, 1, 1, 1, torch.bfloat16, 16),
    ("tc", 1, 1, 1, 2, torch.float32, 16),
    ("tc", 5, 1, 1, 2, torch.bfloat16, 16),
    ("tc", 0, 1, 1, 2, torch.bfloat16, 16),
    ("tc", 1, 3, 1, 2, torch.float16, 16),
    ("tc", 1, 1, 9, 2, torch.bfloat16, 16),
    ("tc", 1, 2, 2, 2, torch.bfloat16, 16),
    ("tc", 1, 1, 2, 2, torch.bfloat16, 0),
    ("tc", 1, 1, 1, 1, torch.bfloat16, 16),
    ("tc", 1, 1, 1, 3, torch.float16, 16),
    ("tc", 3, 1, 1, 4, torch.bfloat16, 16),
    ("simt", 2, 1, 1, 1, torch.float32, 16),
    ("simt", 1, 1, 2, 1, torch.float32, 16),
    ("simt", 1, 1, 1, 2, torch.float32, 16),
    ("tc", 1, 1, 1, 2, torch.bfloat16, 8),
    ("wide", 1, 1, 1, 1, torch.float32, 16),
], ids=lambda c: "-".join(map(str, c)).replace("torch.", ""))
def test_qmatmul_check_plan_refuses_what_the_kernel_does_not_take(case):
    # a plan at x [8, 128] (two 64-column chunks; "0" puts K at 48, one
    # piece) and x's start (8: off a 16-byte boundary)
    body, nt, split, cluster, depth, dtype, where = case
    K = 48 if where == 0 else 128
    with pytest.raises(ValueError):
        qmatmul_cuda.check_plan(
            qmatmul_cuda.Plan(body, nt, split, cluster, depth), 8, K, dtype,
            x_ptr=where)
    qmatmul_cuda.check_plan(qmatmul_cuda.plan(8, 64, K, dtype, SM), 8, K,
                            dtype)


@pytest.mark.parametrize("K", [1, 8, 24, 47, 100, 400, 770, 3073])
def test_qmatmul_plan_takes_any_k(K):
    """A K that is not a multiple of 16 (or a wq off a 16-byte boundary)
    takes the tensor-core body's element-load form, which the C entry
    takes at any alignment; the pieces still cover K once, the last one
    ending at K; fp32 keeps the CUDA-core body."""
    for d in HALF:
        for aligned in (True, False):
            p = qmatmul_cuda.plan(8, 768, K, d, SM, aligned)
            wide = aligned and K % 16 == 0
            assert p.body == ("tc" if wide else "tc_narrow"), (p, aligned)
            qmatmul_cuda.check_plan(p, 8, K, d, x_ptr=0 if wide else 2,
                                    wq_ptr=0 if wide else 8)
            cuts = _pieces(p, K)
            assert len(cuts) == p.split * p.cluster
            assert cuts[0][0] == 0 and cuts[-1][1] == K, (p, cuts)
            for (lo, hi), (nxt, _) in zip(cuts, cuts[1:]):
                assert hi == nxt and lo < hi and lo % 64 == 0, (p, cuts)
    assert qmatmul_cuda.plan(8, 768, K, torch.float32, SM).body == "simt"
    qmatmul_cuda.check_plan(qmatmul_cuda.Plan("simt"), 8, K, torch.float32,
                            x_ptr=4, wq_ptr=3)


@pytest.mark.parametrize("K,x_ptr,wq_ptr", [(100, 0, 0), (24, 0, 0),
                                            (128, 8, 0), (128, 0, 8)])
def test_qmatmul_check_plan_keeps_the_wide_body_aligned(K, x_ptr, wq_ptr):
    """The 16-byte-load body is refused where K is not a multiple of 16 or
    x or wq is off a 16-byte boundary; its element-load form is not."""
    for d in HALF:
        with pytest.raises(ValueError):
            qmatmul_cuda.check_plan(qmatmul_cuda.Plan("tc", 1, 1, 1, 2), 8,
                                    K, d, x_ptr=x_ptr, wq_ptr=wq_ptr)
        qmatmul_cuda.check_plan(qmatmul_cuda.Plan("tc_narrow", 1, 1, 1, 2),
                                8, K, d, x_ptr=x_ptr, wq_ptr=wq_ptr)
