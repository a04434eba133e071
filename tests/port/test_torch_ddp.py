"""Port parity of data parallelism at world 2 on the CPU: two ranks
spawned over gloo (``tests/port/ddp_workers.py``, which imports no JAX)
against ``apex_tpu.parallel`` in ``shard_map`` over a two-device mesh:
``allreduce_gradients``' mean, sum, predivide and fp32 modes; synced
batch norm over the two ranks against full-batch batch norm (JAX's
function on the whole batch, and the port's local one), forward, input
gradient, the running stats and the scale and bias gradients summed over
the ranks; the port of ``test_amp_o2_master_params_identical_across_
ranks`` — three O2 steps on rank-different data leave the fp32 masters
and the bf16 parameters bit-equal on the ranks — against JAX's run of
the same; the found-inf MAX; the compress route (``compress="int8"``
with the residual threaded over three calls, through
``allreduce_gradients`` and ``DistributedDataParallel.init_ef_state``)
against JAX's bit for bit (a sum of two), the collective calls with both
knobs off (one flat all-reduce per dtype, as before the knobs existed),
and the requests that raise (an unknown scheme; hierarchical over one
group).

Tolerances: the reductions 1e-6 (fp32 sums of two); batch norm 1e-5
(fp32 sums over the rows in another order) and its gradients 1e-4; the
O2 masters against JAX's 1e-6 relative.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.optimizers import fused_sgd as jfused_sgd
from apex_tpu.parallel import allreduce_gradients as jallreduce
from apex_tpu.parallel import pvary
from apex_tpu.parallel import sync_batch_norm as jsync_batch_norm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ddp_workers  # noqa: E402

WORLD = 2


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


@pytest.fixture(scope="module")
def ranks():
    rs = np.random.RandomState(0)
    payload = {
        "grads": rs.randn(WORLD, 5, 3).astype(np.float32),
        "bn_x": rs.randn(WORLD, 3, 4, 5, 5).astype(np.float32) * 2 + 1,
        "bn_w": (rs.rand(4) + 0.5).astype(np.float32),
        "bn_b": rs.randn(4).astype(np.float32),
        "bn_cot": rs.randn(WORLD, 3, 4, 5, 5).astype(np.float32),
        "bn_relu": True,
        "w": rs.randn(4, 2).astype(np.float32),
        "xs": rs.randn(WORLD, 3, 4).astype(np.float32),
        "ef_grads": (rs.randn(3, WORLD, 40, 7) * 3).astype(np.float32),
    }
    return payload, ddp_workers.run_ranks(WORLD, payload)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def test_allreduce_gradients_modes_match_jax(ranks):
    payload, out = ranks
    g = jnp.asarray(payload["grads"])

    def run(**kw):
        return shard_map(lambda x: jallreduce({"w": x[0]}, "data", **kw)
                         ["w"][None], mesh=_mesh(), in_specs=(P("data"),),
                         out_specs=P("data"))(g)

    want = {"mean": run(), "sum": run(gradient_average=False),
            "predivide": run(gradient_predivide_factor=4.0)}
    g16 = g.astype(jnp.bfloat16)
    want["fp32_bf16"] = shard_map(
        lambda x: jallreduce({"w": x[0]}, "data", allreduce_always_fp32=True,
                             gradient_predivide_factor=2.0)["w"][None],
        mesh=_mesh(), in_specs=(P("data"),), out_specs=P("data"))(g16)
    for r in range(WORLD):
        for mode, w in want.items():
            _close(out[r]["reduce"][mode], np.asarray(w[r], np.float32),
                   1e-6)


def test_syncbn_over_two_ranks_equals_full_batch(ranks):
    payload, out = ranks
    x = np.concatenate(list(payload["bn_x"]))
    cot = np.concatenate(list(payload["bn_cot"]))
    w, b = payload["bn_w"], payload["bn_b"]

    def full(x, w, b):
        y, rm, rv = jsync_batch_norm(
            x, w, b, None, running_mean=jnp.zeros(4), running_var=jnp.ones(4),
            channel_axis=1, fuse_relu=True)
        return jnp.sum(y * cot), (y, rm, rv)

    (_, (y, rm, rv)), (dx, dw, db) = jax.value_and_grad(
        full, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), w, b)
    _close(np.concatenate([o["syncbn"]["y"] for o in out]), y, 1e-5)
    _close(np.concatenate([o["syncbn"]["dx"] for o in out]), dx, 1e-4)
    _close(sum(o["syncbn"]["dw"] for o in out), dw, 1e-4)
    _close(sum(o["syncbn"]["db"] for o in out), db, 1e-4)
    for o in out:
        _close(o["syncbn"]["rm"], rm, 1e-5)
        _close(o["syncbn"]["rv"], rv, 1e-5)


def test_amp_o2_master_params_identical_across_ranks(ranks):
    payload, out = ranks
    for step in range(3):
        for r in range(1, WORLD):
            assert np.array_equal(out[r]["amp_o2"]["master"][step],
                                  out[0]["amp_o2"]["master"][step])
            assert np.array_equal(out[r]["amp_o2"]["model"][step],
                                  out[0]["amp_o2"]["model"][step])
    assert not np.array_equal(out[0]["amp_o2"]["master"][-1], payload["w"])
    params, opt = jamp.initialize({"w": jnp.asarray(payload["w"])},
                                  jfused_sgd(learning_rate=0.1),
                                  opt_level="O2", verbosity=0)
    state = opt.init(params)

    def steps(params, state, x):
        params = pvary(params, "data")
        state = pvary(state, "data")
        x = x[0]
        for _ in range(3):
            def loss_fn(p):
                return jnp.sum((x.astype(p["w"].dtype) @ p["w"])
                               .astype(jnp.float32) ** 2)

            _, grads, found_inf = jamp.value_and_scaled_grad(loss_fn, opt)(
                params, state)
            grads = jallreduce(grads, "data")
            params, state, _ = opt.apply_gradients(
                grads, state, params, grads_already_unscaled=True,
                found_inf=found_inf)
        return params["w"][None], state.master_params["w"][None]

    model_w, master_w = shard_map(
        steps, mesh=_mesh(), in_specs=(P(), P(), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)(
        params, state, jnp.asarray(payload["xs"]))
    _close(out[0]["amp_o2"]["master"][-1], np.asarray(master_w[0]), 1e-6)
    _close(out[0]["amp_o2"]["model_f32"], np.asarray(model_w[0], np.float32),
           2.0 ** -8)


def test_found_inf_max_over_the_group(ranks):
    _, out = ranks
    assert [o["max"] for o in out] == [True, True]


def test_compress_route_matches_jax(ranks):
    """allreduce_gradients and DDP with compress="int8" and error
    feedback over three calls, bit for bit against JAX's at world 2; with
    both knobs off, one all-reduce per dtype group."""
    from apex_tpu.parallel import DistributedDataParallel as JDDP
    from apex_tpu.parallel import collectives as JC

    payload, out = ranks
    gs = jnp.asarray(payload["ef_grads"])

    def body(g):
        g = g[:, 0]
        trees = [{"w": g[c], "b": g[c][0].astype(jnp.bfloat16)}
                 for c in range(3)]
        ef = JC.ef_init(trees[0], "data", compress="int8")
        fn = []
        for t in trees:
            red, ef = jallreduce(t, "data", compress="int8", ef_state=ef)
            fn.append(red)
        ddp = JDDP(axis_name="data", compress="int8",
                   gradient_predivide_factor=2.0)
        ef2 = ddp.init_ef_state(trees[0])
        dd = []
        for t in trees:
            red, ef2 = ddp.average_gradients(t, ef2)
            dd.append(red)
        return jax.tree_util.tree_map(lambda x: x[None], (fn, ef, dd))

    fn, ef, dd = shard_map(body, mesh=_mesh(), in_specs=(P(None, "data"),),
                           out_specs=P("data"), check_vma=False)(gs)
    for r in range(WORLD):
        so = out[r]["scale_out"]
        assert so["raises"] == [True, True, True]
        assert so["ddp_ef_len"] == 40 * 7 + 7
        np.testing.assert_array_equal(so["fn_ef"], np.asarray(ef[r]))
        for c in range(3):
            for k in ("w", "b"):
                np.testing.assert_array_equal(
                    so["fn"][c][k], np.asarray(fn[c][k][r], np.float32))
                np.testing.assert_array_equal(
                    so["ddp"][c][k], np.asarray(dd[c][k][r], np.float32))
        # knobs off: one flat all-reduce per dtype, the reductions as before
        assert [(str(d), n) for d, n in so["off_calls"]] == [
            ("torch.float32", 280), ("torch.bfloat16", 7)] * 2
        g = payload["ef_grads"][0]
        np.testing.assert_allclose(so["off"]["w"], g.mean(0), rtol=1e-6)
        np.testing.assert_array_equal(so["off"]["w"], so["ddp_off"]["w"])
