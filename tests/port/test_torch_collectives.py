"""Port parity of the collectives layer (``apex_tpu_torch.parallel.
collectives`` and the codec of ``apex_tpu_torch.ops.collectives``)
against ``apex_tpu.parallel.collectives`` on the CPU.

* The codec bit for bit against JAX's: n not a multiple of 128, all-zero,
  inf and NaN blocks, the ``[W, shard]`` rows of the reduce-scatter form,
  the residual, and the sum of gathered payloads.
* JAX's two error-feedback tests, ported: the residual recovers a
  sub-quantum signal; gradient descent through the quantized all-reduce
  converges with the residual where plain int8 stalls (two gloo ranks).
* Knob resolution as JAX's (per-call raises, setter and env preferences
  that fall back, ``disabled()``, ``snapshot``), and the (inner, outer)
  group helper's rank order.
* ``allreduce_tree``, ``reduce_scatter_flat`` and ``all_gather_flat``
  at world 2 and at world 4 as (2, 2) (plain, int8, hierarchical, both),
  the residual threaded over 3 calls, against JAX in ``shard_map`` over
  the conftest's CPU devices: bit for bit at world 2 and on the (2, 2)
  routes whose sums are of two terms, within 1e-6 of the largest
  magnitude otherwise (a sum of four in another order); DDP's
  hierarchical route at world 4.

The port runs in gloo ranks spawned by ``tests/port/zero_workers.py``,
which imports no JAX; inputs come from a seeded numpy ``RandomState``.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import collectives as JC
from apex_tpu.parallel.distributed import allreduce_gradients as jallreduce
from apex_tpu_torch.ops import collectives as codec
from apex_tpu_torch.parallel import collectives as C

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import zero_workers  # noqa: E402

N_X = 1000          # divisible by 2 and 4; 500 and 250 are not 128-multiples
PAIR = ("dp_in", "dp_out")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in ("APEX_GRAD_COMPRESS", "APEX_HIER_ALLREDUCE", "APEX_DISPATCH",
              "APEX_DISPATCH_TABLE"):
        monkeypatch.delenv(k, raising=False)
    for mod in (C, JC):
        mod._reset_for_tests()
    yield
    for mod in (C, JC):
        mod._reset_for_tests()


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _same_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------- codec

def _codec_inputs():
    rs = np.random.RandomState(0)
    x = (rs.randn(1000) * 10).astype(np.float32)
    x[128:256] = 0.0                       # an all-zero block
    x[300] = np.inf                        # an inf block
    x[600] = np.nan                        # a NaN block
    x[700] = -np.inf
    x[5] = 127.0
    res = (rs.randn(1000) * 0.01).astype(np.float32)
    return x, res


@pytest.mark.parametrize("n", [1, 127, 300, 1000])
def test_codec_bit_for_bit_against_jax(n):
    x, res = _codec_inputs()
    x, res = x[:n], res[:n]
    comp, emit = JC._compensate(jnp.asarray(x), jnp.asarray(res))
    jq, js = JC.quantize_blocks(comp)
    jres = emit(jq, js)
    q, s, r = codec.quantize_reference(torch.from_numpy(x),
                                       torch.from_numpy(res))
    _same_bits(q.numpy(), jq)
    _same_bits(s.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    _same_bits(r.numpy(), jres)
    assert np.isfinite(r.numpy()).all()
    # the inf / NaN blocks poison to non-finite after dequantization
    dq = codec.dequantize_reference(q, s, n).numpy()
    _same_bits(dq, JC.dequantize_blocks(jq, js, n))
    for bad in (300, 600, 700):
        if bad < n:
            assert not np.isfinite(dq[bad // 128 * 128]).any()
    # no residual: the codec alone
    q0, s0, r0 = codec.quantize_reference(torch.from_numpy(x))
    jq0, js0 = JC.quantize_blocks(jnp.asarray(x))
    assert r0 is None
    _same_bits(q0.numpy(), jq0)
    _same_bits(s0.view(torch.int16).numpy(), np.asarray(js0).view(np.int16))


def test_codec_rows_and_the_sum_against_jax():
    """The reduce-scatter form (rows [W, shard], each padded on its own)
    and K20's plain sum / gather against JAX's jnp bodies."""
    rs = np.random.RandomState(1)
    for world, shard in ((2, 500), (4, 250)):
        x = (rs.randn(world * shard) * 3).astype(np.float32)
        res = (rs.randn(world * shard) * 0.01).astype(np.float32)
        xb = jnp.asarray(x + res).reshape(world, shard)
        jq, js = JC.quantize_blocks(xb)
        jdq = JC.dequantize_blocks(jq, js, shard)
        jres = jnp.where(jnp.isfinite(jdq), xb - jdq, 0.0).reshape(-1)
        q, s, r = codec.quantize_reference(
            torch.from_numpy(x).view(world, shard),
            torch.from_numpy(res).view(world, shard))
        _same_bits(q.numpy(), jq)
        _same_bits(r.reshape(-1).numpy(), jres)
        jsum = jnp.sum(jq.astype(jnp.float32)
                       * js.astype(jnp.float32)[..., None], axis=0)
        got = codec.dequantize_sum_reference(q, s, shard).numpy()
        want = np.asarray(jsum.reshape(-1)[:shard])
        if world == 2:
            _same_bits(got, want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        got = codec.dequantize_sum_reference(q, s, shard, divisor=world)
        np.testing.assert_allclose(got.numpy(), want / world, rtol=1e-6)
        gathered = codec.dequantize_sum_reference(q, s, shard, gather=True)
        _same_bits(gathered.numpy(), np.asarray(jdq).reshape(-1))


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_skip_keeps_the_residual(opt):
    """A ZeRO step whose found-inf flag is set leaves the error-feedback
    residuals as they were, so the steps after it continue as if it had
    not been taken (one rank without a process group: the collectives are
    the identity, the codec runs)."""
    from apex_tpu_torch.contrib.optimizers import (distributed_fused_adam,
                                                   distributed_fused_lamb)

    make = distributed_fused_adam if opt == "adam" else \
        distributed_fused_lamb
    rs = np.random.RandomState(5)
    grads = [{"a": torch.from_numpy(rs.randn(300).astype(np.float32)),
              "b": torch.from_numpy(rs.randn(7, 9).astype(np.float32))}
             for _ in range(2)]
    runs = []
    for skipped in (False, True):
        tx = make(learning_rate=0.01, num_shards=1, grad_compress="int8")
        params = {"a": torch.ones(300), "b": torch.zeros(7, 9)}
        state = tx.init(params)
        tx.step(grads[0], state, params)
        first = state.g_residual.clone(), state.u_residual.clone()
        if skipped:
            tx.step(grads[1], state, params, found_inf=torch.tensor(True))
            assert torch.equal(state.g_residual, first[0])
            assert torch.equal(state.u_residual, first[1])
        tx.step(grads[1], state, params, found_inf=torch.tensor(False))
        assert first[0].abs().max() > 0 and first[1].abs().max() > 0
        assert not torch.equal(state.g_residual, first[0])
        runs.append((params, state))
    for k in ("a", "b"):
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    for f in ("g_residual", "u_residual", "m", "v", "master"):
        assert torch.equal(getattr(runs[0][1], f), getattr(runs[1][1], f))


def test_error_feedback_recovers_subquantum_signal():
    """JAX's test: a 0.3 signal in a block whose quantum is ~0.79
    quantizes to 0 every step without feedback; with the residual carried
    the emitted sum over 16 steps approaches 16 x 0.3."""
    x = torch.zeros(128)
    x[0], x[1] = 100.0, 0.3

    def run(residual):
        emitted = np.zeros(128, np.float64)
        res = residual
        for _ in range(16):
            q, s, new = codec.quantize_reference(x, res)
            emitted += codec.dequantize_reference(q, s, 128).double().numpy()
            res = new
        return emitted

    no_ef, with_ef = run(None), run(torch.zeros(128))
    assert no_ef[1] == 0.0
    assert abs(with_ef[1] - 16 * 0.3) <= 100.0 / 127.0 + 0.05, with_ef[1]


# ---------------------------------------------------------------- knobs

def test_per_call_raises_preferences_fall_back():
    with pytest.raises(ValueError):
        C.resolve_compress("fp4")
    with pytest.raises(ValueError):
        C.resolve_hier(True, (None,))
    with pytest.raises(ValueError):
        C.set_grad_compress("fp4")
    with pytest.raises(ValueError):
        C.set_hier_allreduce("yes")
    C.set_hier_allreduce(True)
    assert C.resolve_hier(None, (None,)) is False
    assert C.resolve_hier(None, ("in", "out")) is True
    C.set_hier_allreduce(None)
    os.environ["APEX_GRAD_COMPRESS"] = "fp4"
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert C.resolve_compress(None) is None
            assert C.resolve_compress(None) is None
        assert len([w for w in rec
                    if "APEX_GRAD_COMPRESS" in str(w.message)]) == 1
    finally:
        del os.environ["APEX_GRAD_COMPRESS"]
        C._reset_for_tests()
    os.environ["APEX_HIER_ALLREDUCE"] = "true"
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert C.resolve_hier(None, ("a", "b")) is False
        assert any("APEX_HIER_ALLREDUCE" in str(w.message) for w in rec)
    finally:
        del os.environ["APEX_HIER_ALLREDUCE"]
        C._reset_for_tests()
    C.set_grad_compress("int8")
    assert C.resolve_compress(False) is None
    assert C.resolve_compress("off") is None
    assert C.resolve_compress(None) == "int8"
    C.set_grad_compress(None)
    # the table tier is a miss: with nothing set, everything is off
    assert C.resolve_compress(None, nelems=10 ** 9) is None
    assert C.resolve_hier(None, ("a", "b"), nelems=10 ** 9) is False


def test_snapshot_and_disabled(monkeypatch):
    assert C.snapshot() == JC.snapshot() == {
        "scheme": None, "hierarchical": False, "block": C.DEFAULT_BLOCK}
    monkeypatch.setenv("APEX_GRAD_COMPRESS", "int8")
    monkeypatch.setenv("APEX_HIER_ALLREDUCE", "1")
    assert C.snapshot()["scheme"] == "int8"
    assert C.snapshot()["hierarchical"] is True
    assert C.snapshot(axes=(None,))["hierarchical"] is False
    with C.disabled():
        assert C.resolve_compress(None) is None
        assert C.resolve_hier(None, ("a", "b")) is False
        assert C.resolve_compress("int8") == "int8"
        assert C.snapshot() == {"scheme": None, "hierarchical": False,
                                "block": C.DEFAULT_BLOCK}
    assert C.resolve_compress(None) == "int8"


def test_axes_helpers_without_a_process_group():
    assert C.axes_tuple(None) == (None,)
    pair = C.AxisPair("in", "out", "whole")
    assert C.axes_tuple(pair) is pair and pair.whole == "whole"
    assert C.axes_size(None) == 1 and C.axes_index(None) == 0
    x = torch.arange(6.0)
    y, r = C.reduce_scatter_flat(x, None)
    assert torch.equal(y, x) and r is None
    full, _ = C.all_gather_flat(x, None, gather_dtype=torch.bfloat16)
    assert full.dtype == torch.float32 and torch.equal(full, x)


# ---------------------------------------------------- entry points, ranks

def _payload(world, configs):
    rs = np.random.RandomState(10 + world)
    return {"configs": configs,
            "tree_a": (rs.randn(3, world, 7, 11) * 2).astype(np.float32),
            "tree_b": (rs.randn(3, world, 300) * 5).astype(np.float32),
            "x": (rs.randn(3, world, N_X) * 4).astype(np.float32),
            "ddp_grads": (rs.randn(3, world, 9, 13)).astype(np.float32)}


CONFIGS = {2: [(None, False), ("int8", False)],
           4: [(None, False), ("int8", False), (None, True),
               ("int8", True)]}


@pytest.fixture(scope="module")
def ranks():
    out = {}
    for world in (2, 4):
        payload = _payload(world, CONFIGS[world])
        out[world] = (payload, zero_workers.run_ranks(
            zero_workers.collectives_case, world, payload))
    return out


def _mesh(world):
    if world == 2:
        return Mesh(np.array(jax.devices()[:2]), ("dp",)), "dp", P(None,
                                                                    "dp")
    return (Mesh(np.array(jax.devices()[:4]).reshape(2, 2), PAIR), PAIR,
            P(None, PAIR))


def _jax_entry_points(world, payload, compress, hier):
    mesh, axis, spec = _mesh(world)
    out_spec = P(spec[1])
    kw = dict(compress=compress or False, hierarchical=hier)
    m = N_X // world

    def body(ta, tb, xs):
        first = {"a": ta[0, 0], "b": tb[0, 0]}
        ef = JC.ef_init(first, axis, **kw)
        outs = []
        for c in range(3):
            red, ef = JC.allreduce_tree({"a": ta[c, 0], "b": tb[c, 0]}, axis,
                                        mean=True, ef_state=ef, **kw)
            outs += [red["a"], red["b"]]
        outs.append(jnp.zeros(1) if ef is None else ef)
        g_len = N_X // 2 if hier else N_X
        res = jnp.zeros((g_len,), jnp.float32) if compress else None
        for c in range(3):
            y, res = JC.reduce_scatter_flat(xs[c, 0], axis, residual=res,
                                            **kw)
            outs.append(y)
        outs.append(jnp.zeros(1) if res is None else res)
        res = jnp.zeros((m,), jnp.float32) if compress else None
        for c in range(3):
            full, res = JC.all_gather_flat(xs[c, 0][:m], axis, residual=res,
                                           **kw)
            outs.append(full)
        outs.append(jnp.zeros(1) if res is None else res)
        return tuple(o[None] for o in outs)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=out_spec, check_vma=False))
    got = f(payload["tree_a"], payload["tree_b"], payload["x"])
    return [np.asarray(g) for g in got]


def _exact(world, hier):
    """Where every sum is of two terms: world 2, or (2, 2) on the
    hierarchical routes (inner then outer, each of two)."""
    return world == 2 or hier


@pytest.mark.parametrize("world,compress,hier",
                         [(w, c, h) for w in (2, 4) for c, h in CONFIGS[w]])
def test_entry_points_match_jax(ranks, world, compress, hier):
    payload, out = ranks[world]
    want = _jax_entry_points(world, payload, compress, hier)
    tol = 1e-6
    for r in range(world):
        o = out[r][(compress, hier)]
        got = [t for pair in o["tree"] for t in pair]
        got.append(o["tree_ef"])
        got += o["rs"] + [o["rs_res"]] + o["ag"] + [o["ag_res"]]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            w = w[r]
            if g is None:
                assert not compress and w.shape == (1,), i
                continue
            assert g.shape == w.shape, (i, g.shape, w.shape)
            if _exact(world, hier):
                _same_bits(g, w)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"output {i} rank {r}")
        if compress:
            total = 7 * 11 + 300
            assert o["ef_len"] == (-(-total // 2) if hier else total)
        else:
            assert o["ef_len"] == -1


def test_hierarchical_equals_flat_and_bitwise_replicas(ranks):
    """At (2, 2) the hierarchical route gives the flat one's values within
    1e-6, and every rank holds the same all-reduced bits."""
    _, out = ranks[4]
    for r in range(4):
        flat = out[r][(None, False)]["tree"]
        hier = out[r][(None, True)]["tree"]
        for (fa, fb), (ha, hb) in zip(flat, hier):
            np.testing.assert_allclose(ha, fa, rtol=0,
                                       atol=1e-6 * np.abs(fa).max())
            np.testing.assert_allclose(hb, fb, rtol=0,
                                       atol=1e-6 * np.abs(fb).max())
        for cfg in CONFIGS[4]:
            for a, b in zip(out[r][cfg]["tree"], out[0][cfg]["tree"]):
                _same_bits(a[0], b[0])
                _same_bits(a[1], b[1])


def test_error_feedback_converges_where_plain_int8_stalls(ranks):
    """JAX's test, at world 2: the small coordinates descend with the
    residual and never move without it."""
    _, out = ranks[2]
    for o in out:
        w_ef, w_plain = o["ef_gd"][True], o["ef_gd"][False]
        assert np.abs(w_ef[1:]).max() < 0.3, np.abs(w_ef[1:]).max()
        assert abs(np.abs(w_plain[1:]).min() - 0.6) < 1e-6


def test_ddp_hierarchical_route_matches_jax(ranks):
    payload, out = ranks[4]
    mesh, axis, spec = _mesh(4)
    grads = payload["ddp_grads"]

    def body(gs):
        hier = jallreduce({"w": gs[0, 0]}, axis, hierarchical=True)["w"]
        ef = JC.ef_init({"w": gs[0, 0]}, axis, compress="int8",
                        hierarchical=True)
        steps = []
        for c in range(3):
            red, ef = jallreduce({"w": gs[c, 0]}, axis, compress="int8",
                                 hierarchical=True, ef_state=ef)
            steps.append(red["w"])
        return hier[None], jnp.stack(steps)[None]

    hier, steps = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                                    out_specs=P(spec[1]),
                                    check_vma=False))(grads)
    for r in range(4):
        o = out[r]["ddp"]
        assert o["single_group_raises"]
        assert o["ef_len"] == 9 * 13 // 2 + 1
        _same_bits(o["hier"], np.asarray(hier[r]))
        for c in range(3):
            _same_bits(o["hier_int8"][c], np.asarray(steps[r][c]))
