"""Port parity of the ZeRO-2 optimizers (``apex_tpu_torch.contrib.
optimizers``: ``distributed_fused_adam`` / ``_lamb`` and their classes)
against ``apex_tpu.contrib.optimizers`` in ``shard_map`` over the
conftest's CPU devices, the port in gloo ranks spawned by
``tests/port/zero_workers.py`` (no JAX there); inputs from seeded numpy.

* JAX's ZeRO trajectory test, both optimizers: 20 steps on its regression
  problem at world 2 (flat, int8) and at world 4 as (2, 2) (flat,
  hierarchical, hierarchical with int8). Every run, compressed or
  not, against JAX's at JAX's tolerances (rtol 2e-6, atol 1e-7 for Adam,
  as JAX holds its ZeRO run to the unsharded optimizer; 1e-5 for LAMB,
  the fused LAMB tests' band): the codec is JAX's bit for bit. A
  compressed run also at most 0.06 relative from the uncompressed one at
  every step, as JAX's is, and falling (Adam's to a fifth, as in JAX's
  test).
* JAX's ``test_distributed_optimizers.py`` cases: three steps on
  replicated gradients against the port's unsharded ``fused_adam`` /
  ``fused_lamb`` (rtol 2e-5 / 2e-4, JAX's) and against JAX's sharded run
  (1e-6), the shard's length, rank-distinct gradients (their mean).
* The pure ``update`` against the fused ``step``; a state loaded from
  JAX's through ``DistAdamState.from_numpy`` continues as JAX's does; the
  class surfaces; a step with the found-inf flag writes nothing.
* The slice as a whole: a 2-layer BERT at world 2 on
  ``DistributedFusedLAMB`` through ``make_one_step``, 3 steps in fp32,
  each rank on its half of the batch, against JAX's ``BertModel`` with
  ``distributed_fused_lamb`` in ``shard_map`` over two devices: the losses
  within 1e-5 relative, each parameter tensor within 1e-5 relative L2 and
  each element within JAX's own sharded-vs-unsharded LAMB band (rtol
  2e-4, atol 1e-6): an Adam-style direction amplifies the packages' fp32
  summation differences where a moment cancels, so a single element can
  move past 1e-5 of its tensor's largest magnitude.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

import test_torch_bert as bert
import test_torch_training as training
from apex_tpu.contrib.optimizers import distributed_fused_adam as jdadam
from apex_tpu.contrib.optimizers import distributed_fused_lamb as jdlamb
from apex_tpu.parallel import collectives as JC
from apex_tpu.transformer.parallel_state import TENSOR_AXIS
from apex_tpu.transformer.testing import BertModel as JBert
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.optimizers._base import apply_plain

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import zero_workers  # noqa: E402

PAIR = ("dp_in", "dp_out")
CONFIGS = {2: [("adam", None, False), ("adam", "int8", False),
               ("lamb", None, False), ("lamb", "int8", False)],
           4: [("adam", None, False), ("adam", None, True),
               ("adam", "int8", True), ("lamb", None, False),
               ("lamb", None, True), ("lamb", "int8", True)]}
BERT_KW = dict(bert.KW)
# LAMB's eps in the BERT case. A zero-initialized bias moves by ~lr a step,
# and an element whose gradient g is near zero moves by ~lr g / eps, so the
# two packages' fp32 summation orders (|dg| ~ 1e-9 here) show up in the
# parameters as lr |dg| / eps: at the default 1e-6 that is past 1e-5 of the
# bias's largest magnitude after three steps (a few lm_head.bias entries),
# at 1e-3 it is far inside it
BERT_EPS = 1e-3


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("APEX_GRAD_COMPRESS", "APEX_HIER_ALLREDUCE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("APEX_DISPATCH", "off")
    JC._reset_for_tests()


def _regression():
    rs = np.random.RandomState(3)
    X = rs.randn(32, 40).astype(np.float32)
    w_true = rs.randn(40).astype(np.float32)
    return X, (X @ w_true).astype(np.float32)


def _params_grads():
    rs0, rs1 = np.random.RandomState(0), np.random.RandomState(1)
    params = {"a": rs0.randn(13, 7), "b": rs0.randn(5), "c": rs0.randn(3, 3, 3)}
    grads = {"a": rs1.randn(13, 7), "b": rs1.randn(5), "c": rs1.randn(3, 3, 3)}
    return ({k: v.astype(np.float32) for k, v in params.items()},
            {k: v.astype(np.float32) for k, v in grads.items()})


def _mesh(world):
    if world == 2:
        return Mesh(np.array(jax.devices()[:2]), ("dp",)), "dp"
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), PAIR), PAIR


def _jax_state1(params, grads):
    """JAX's distributed Adam after one step: each rank's state and the
    parameters."""
    mesh, axis = _mesh(2)
    tx = jdadam(learning_rate=0.1, weight_decay=0.01, num_shards=2,
                axis_name=axis)

    def run(p, g):
        st = tx.init(p)
        upd, st = tx.update(g, st, p)
        p = jax.tree_util.tree_map(jnp.add, p, upd)
        return p, st.count[None], st.m[None], st.v[None], st.master[None]

    out = shard_map(run, mesh=mesh, in_specs=(P(), P()),
                    out_specs=(P(), P("dp"), P("dp"), P("dp"), P("dp")),
                    check_vma=False)(params, grads)
    p1 = {k: np.asarray(v) for k, v in out[0].items()}
    states = [{"count": int(out[1][r]), "m": np.asarray(out[2][r]),
               "v": np.asarray(out[3][r]), "master": np.asarray(out[4][r])}
              for r in range(2)]
    return p1, states


def _bert_batch():
    rs = np.random.RandomState(4)
    b, s, v = 4, 128, BERT_KW["vocab_size"]
    ids = rs.randint(0, v, (b, s)).astype(np.int32)
    labels = rs.randint(0, v, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, valid in enumerate((s, s - 51, 77, 1)):
        mask[row, valid:] = 0
        ids[row, valid:] = 0
    return ids, mask, labels


@pytest.fixture(scope="module")
def bert_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        ids, mask, _ = _bert_batch()
        jm = JBert(training._jax_config(BERT_KW))
        tree = training._shmap(lambda i, m: jm.init(
            jax.random.PRNGKey(0), i, m)["params"], 2)(ids[:2], mask[:2])
        return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ranks(bert_tree):
    X, y = _regression()
    params, grads = _params_grads()
    ids, mask, labels = _bert_batch()
    out = {}
    # this fixture is set up before the autouse ``_clean``: the ranks get
    # the same knobs here (the environment they inherit) whatever ran
    # before in this process
    with pytest.MonkeyPatch.context() as mp:
        for k in ("APEX_GRAD_COMPRESS", "APEX_HIER_ALLREDUCE"):
            mp.delenv(k, raising=False)
        mp.setenv("APEX_DISPATCH", "off")
        JC._reset_for_tests()
        p1, states = _jax_state1(params, grads)
        for world in (2, 4):
            payload = {"X": X, "y": y, "zero_configs": CONFIGS[world],
                       "params": params, "grads": grads, "jax_params1": p1,
                       "jax_state1": states, "bert_kw": BERT_KW,
                       "bert_tree": bert_tree, "bert_ids": ids,
                       "bert_mask": mask, "bert_labels": labels,
                       "bert_eps": BERT_EPS}
            case = zero_workers.zero_case if world == 2 else \
                zero_workers.zero_trajectories_case
            out[world] = zero_workers.run_ranks(case, world, payload)
    return out


def _jax_trajectory(world, opt, compress, hier, steps=20):
    """JAX's ``_zero_trajectory`` (tests/test_collectives.py) at this
    world, both optimizers."""
    X, y = (jnp.asarray(a) for a in _regression())
    mesh, axis = _mesh(world)
    make = jdadam if opt == "adam" else jdlamb
    kw = dict(learning_rate=0.05) if opt == "adam" else dict(
        learning_rate=0.05, weight_decay=0.01, max_grad_norm=1.0)
    tx = make(num_shards=world, axis_name=axis, grad_compress=compress or
              "off", hier_allreduce=hier, **kw)
    params = {"w": jnp.zeros((40,), jnp.float32),
              "b": jnp.zeros((1,), jnp.float32)}

    def loss_fn(p):
        return jnp.mean((X @ p["w"] + p["b"][0] - y) ** 2)

    def run(p):
        st = tx.init(p)

        def body(carry, _):
            p, st = carry
            loss, g = jax.value_and_grad(loss_fn)(p)
            upd, st = tx.update(g, st, p)
            return (jax.tree_util.tree_map(jnp.add, p, upd), st), loss

        (_, _), losses = lax.scan(body, (p, st), jnp.arange(steps))
        return losses

    f = jax.jit(shard_map(run, mesh=mesh, in_specs=(P(),), out_specs=P(),
                          check_vma=False))
    return np.asarray(f(params), np.float64)


def _traj(out, world):
    return out[world][0]["traj"] if world == 2 else out[world][0]


@pytest.mark.parametrize("world,opt,compress,hier",
                         [(w,) + c for w in (2, 4) for c in CONFIGS[w]])
def test_zero_trajectory_matches_jax(ranks, world, opt, compress, hier):
    got = _traj(ranks, world)[(opt, compress, hier)]
    for r in range(1, world):   # every rank saw the same losses
        other = ranks[world][r]["traj"] if world == 2 else ranks[world][r]
        np.testing.assert_array_equal(other[(opt, compress, hier)], got)
    want = _jax_trajectory(world, opt, compress, hier)
    # the codec is JAX's bit for bit, so a compressed run (its residuals
    # carried over the steps) is held to JAX's as tightly as a flat one
    if opt == "adam":
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if compress is None:
        return
    flat = _traj(ranks, world)[(opt, None, False)]
    for run in (got, want):
        dev = np.abs(run - flat) / np.maximum(np.abs(flat), 1e-8)
        assert dev.max() <= 0.06, (dev.max(), run[-5:], flat[-5:])
        # Adam converges as in JAX's test; LAMB (lr 0.05 scaled by the
        # trust ratio) falls more slowly here, in both packages
        assert run[-1] < run[0] * (0.2 if opt == "adam" else 1.0)


def _jax_sharded(make, kw, params, grads, world=2, steps=3):
    mesh, axis = _mesh(world)
    tx = make(num_shards=world, axis_name=axis, **kw)

    def run(p, g):
        st = tx.init(p)
        for _ in range(steps):
            upd, st = tx.update(g, st, p)
            p = jax.tree_util.tree_map(jnp.add, p, upd)
        return p

    return shard_map(run, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                     check_vma=False)(params, grads)


def _unsharded(tx, params, grads, steps=3):
    ps = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    gs = {k: torch.from_numpy(v) for k, v in grads.items()}
    state = tx.init(ps)
    for _ in range(steps):
        apply_plain(tx.update, gs, state, ps)
    return {k: v.numpy() for k, v in ps.items()}


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_sharded_matches_unsharded_and_jax(ranks, opt):
    params, grads = _params_grads()
    if opt == "adam":
        kw, rtol = dict(learning_rate=0.1, weight_decay=0.01), 2e-5
        ref = _unsharded(fused_adam(**kw), params, grads)
        want = _jax_sharded(jdadam, kw, params, grads)
    else:
        kw = dict(learning_rate=0.01, weight_decay=0.01, max_grad_norm=1.0)
        rtol = 2e-4
        ref = _unsharded(fused_lamb(**kw), params, grads)
        want = _jax_sharded(jdlamb, kw, params, grads)
    total = sum(v.size for v in params.values())
    for o in ranks[2]:
        assert o[opt + "_shard_len"] == (total + 1) // 2
        assert o[opt + "_update_vs_step"] == 0.0
        for k in params:
            np.testing.assert_allclose(o[opt][k], ref[k], rtol=rtol,
                                       atol=1e-6)
            np.testing.assert_allclose(o[opt][k], np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_distinct_rank_grads_average(ranks):
    params = {"w": torch.zeros(16)}
    tx = fused_adam(learning_rate=0.1)
    apply_plain(tx.update, {"w": torch.full((16,), 1.5)}, tx.init(params),
                params)
    for o in ranks[2]:
        np.testing.assert_allclose(o["distinct"], params["w"].numpy(),
                                   rtol=1e-5)


def test_state_from_jax_continues_as_jax(ranks):
    params, grads = _params_grads()
    want = _jax_sharded(jdadam, dict(learning_rate=0.1, weight_decay=0.01),
                        params, grads, steps=2)
    for o in ranks[2]:
        for k in params:
            np.testing.assert_allclose(o["from_numpy"][k],
                                       np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)


def test_class_surfaces_and_the_skipped_step(ranks):
    params, grads = _params_grads()
    want = _jax_sharded(jdlamb, dict(learning_rate=0.01), params, grads,
                        steps=1)
    for o in ranks[2]:
        c = o["classes"]
        assert c["adam_class_equals_transform"] and c["amsgrad_refused"]
        for got, k in zip(c["lamb"], params):
            np.testing.assert_allclose(got, np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)
        assert o["skip"] == {"distributed_fused_adam": True,
                             "distributed_fused_lamb": True}


def test_bert_on_distributed_fused_lamb_matches_jax(ranks, bert_tree):
    """The slice as a whole, narrowed: JAX's step in shard_map over a
    (dp 2, tensor 1) mesh, each dp rank on its half of the batch, the
    loss each rank's own mean; the port's ranks through make_one_step
    with a GradScaler over the group."""
    ids, mask, labels = _bert_batch()
    jm = JBert(training._jax_config(BERT_KW))
    tx = jdlamb(learning_rate=1e-2, eps=BERT_EPS, num_shards=2,
                axis_name="dp")
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                ("dp", TENSOR_AXIS))

    def run(p, i, m, lab):
        st = tx.init(p)
        losses = []
        for _ in range(3):
            def loss_fn(pp):
                return jnp.mean(jm.apply({"params": pp}, i, m,
                                         lm_labels=lab)[0])

            loss, g = jax.value_and_grad(loss_fn)(p)
            upd, st = tx.update(g, st, p)
            p = jax.tree_util.tree_map(jnp.add, p, upd)
            losses.append(loss)
        return p, jnp.stack(losses)[None]

    params = jax.tree_util.tree_map(jnp.asarray, bert_tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        jp, jl = jax.jit(shard_map(
            run, mesh=mesh, in_specs=(P(), P("dp"), P("dp"), P("dp")),
            out_specs=(P(), P("dp")), check_vma=False))(
            params, ids, mask, labels)
    want = training._flat_jax(jp)
    for r, o in enumerate(ranks[2]):
        b = o["bert"]
        assert b["reduce_scatters"] == 3
        np.testing.assert_allclose(b["losses"], np.asarray(jl[r]),
                                   rtol=1e-5)
        got = _as_jax_names(b["params"])
        assert set(got) == set(want)
        for k in want:
            g, w = got[k].astype(np.float64), want[k].astype(np.float64)
            rel_l2 = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel_l2 <= 1e-5, (k, rel_l2)
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6,
                                       err_msg=k)
    for k, v in ranks[2][0]["bert"]["params"].items():
        np.testing.assert_array_equal(ranks[2][1]["bert"]["params"][k], v)


def _as_jax_names(params):
    """The port's parameters as the JAX tree's flat leaves (flax Dense
    weights back as kernels), through the converter of the BERT tests."""
    tree = {}
    for name, p in params.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(p)
    from apex_tpu_torch.serving import weights as tweights
    return training._flat_jax(tweights.to_numpy_tree(tree))
