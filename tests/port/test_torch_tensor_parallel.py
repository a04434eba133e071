"""Port parity of tensor parallelism on ``torch.distributed``: the port's
mappings, layers, GPT model and training step in 2 or 4 ranks (gloo on
CPU tensors, the ranks in ``tp_workers.py``) against the JAX package's
inside ``shard_map`` over ``Mesh(jax.devices()[:tp], ("tp",))`` on the
8-device CPU mesh, as ``tests/test_transformer_models.py:39`` runs them.

The GPT cases (2 layers, h = 128, 4 heads, V = 512, b = 2, s = 16; no
dropout, ``recompute_granularity="none"``, ``APEX_DISPATCH=off``) run
both heads: the materialized one (vocab-parallel cross entropy) and the
fused one (JAX's sharded Pallas head in interpret mode, the port's
``linear_cross_entropy_sharded``). The JAX tree is drawn at tp = 1 and
each side takes its rank's slices (JAX through ``in_specs`` found by
comparing the shapes its model inits at tp = 2 with the full ones, the
port through ``serving.weights.shard_param_tree``).

Tolerances, fp32: the mappings' and layers' outputs and gradients within
1e-6 of each tensor's largest magnitude (one rounding of the same sums,
another order); the GPT per-token loss and every gradient within 1e-4 of
the largest magnitude, the losses of a 3-step trajectory within 1e-5
relative and each parameter's total update within 5e-3 in relative L2, as
``test_torch_training.py`` holds tp = 1; the port at tp =
2 against its own tp = 1 on one seed: parameters bit for bit, losses and
gradients within 1e-5 of the largest magnitude. Replicated parameters'
gradients are equal on every rank, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bench
import tp_workers
from apex_tpu.ops import xent_pallas
from apex_tpu.optimizers.fused_adam import fused_adam as jfused_adam
from apex_tpu.serving import model as jserving
from apex_tpu.transformer.amp.grad_scaler import GradScaler as JGradScaler
from apex_tpu.transformer.tensor_parallel import layers as jlayers
from apex_tpu.transformer.tensor_parallel import mappings as jmappings
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.transformer.testing import GPTModel, TransformerConfig
from apex_tpu_torch.transformer.testing import standalone_transformer_lm

torch.set_num_threads(2)

KW = dict(hidden_size=128, num_layers=2, num_attention_heads=4,
          vocab_size=512, max_position_embeddings=32, hidden_dropout=0.0,
          attention_dropout=0.0, recompute_granularity="none")
HEADS = {"materialized": False, "fused": True}
B, S, LR, STEPS = 2, 16, 1e-3, 3
MAPPINGS = ("copy_to_tensor_model_parallel_region",
            "reduce_from_tensor_model_parallel_region",
            "scatter_to_tensor_model_parallel_region",
            "gather_from_tensor_model_parallel_region")


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]), ("tp",))


def _smap(f, tp, in_specs, out_specs):
    return jax.jit(jax.shard_map(f, mesh=_mesh(tp), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    atol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=0, err_msg=name)


# ------------------------------ mappings ------------------------------------

def _mapping_payload(tp):
    rs = np.random.RandomState(tp)
    x = rs.randn(tp, 4, 8).astype(np.float32)
    last = {"scatter_to_tensor_model_parallel_region": 8 // tp,
            "gather_from_tensor_model_parallel_region": 8 * tp}
    g = {name: rs.randn(tp, 4, last.get(name, 8)).astype(np.float32)
         for name in MAPPINGS}
    return x, g


@pytest.mark.parametrize("tp", [2, 4])
def test_mappings_match_jax(tp):
    x, g = _mapping_payload(tp)
    port = tp_workers.run_ranks(tp_workers.mappings_case, tp,
                                dict(x=x, g=g))
    for name in MAPPINGS:
        fn = getattr(jmappings, name)

        def run(xx, gg, fn=fn):
            y, vjp = jax.vjp(lambda a: fn(a[0], "tp")[None], xx)
            return y, vjp(gg)[0]

        y_j, dx_j = _smap(run, tp, (P("tp"), P("tp")), (P("tp"), P("tp")))(
            x, g[name])
        for rank, out in enumerate(port):
            y, dx = out[name]
            _close(y, np.asarray(y_j)[rank], 1e-6, f"{name} y rank {rank}")
            _close(dx, np.asarray(dx_j)[rank], 1e-6,
                   f"{name} dx rank {rank}")


# ------------------------------- layers -------------------------------------

def _layer_payload(tp):
    rs = np.random.RandomState(7)
    rows, n_in, n_out = 6, 16, 8 * tp
    p = dict(x=rs.randn(rows, n_in).astype(np.float32),
             w_col=rs.randn(n_out, n_in).astype(np.float32),
             b_col=rs.randn(n_out).astype(np.float32),
             w_row=rs.randn(n_in, n_out).astype(np.float32),
             b_row=rs.randn(n_in).astype(np.float32),
             x_row=rs.randn(rows, n_out).astype(np.float32),
             g_row=rs.randn(rows, n_in).astype(np.float32),
             table=rs.randn(16 * tp, 8).astype(np.float32),
             ids=rs.randint(0, 16 * tp, (3, 5)).astype(np.int64),
             g_emb=rs.randn(3, 5, 8).astype(np.float32))
    g_full = rs.randn(rows, n_out).astype(np.float32)
    c = n_out // tp
    p["g_col_True"] = [g_full] * tp
    p["g_col_False"] = [g_full[:, r * c:(r + 1) * c] for r in range(tp)]
    return p, g_full


def test_column_row_and_vocab_parallel_layers_match_jax():
    tp = 2
    p, g_full = _layer_payload(tp)
    port = tp_workers.run_ranks(tp_workers.layers_case, tp, p)
    n_out, n_in = p["w_col"].shape
    col_spec = {"weight": P("tp", None), "bias": P("tp")}
    for gather in (True, False):
        mod = jlayers.ColumnParallelLinear(n_in, n_out, gather_output=gather,
                                           axis_name="tp")
        out_spec = P() if gather else P(None, "tp")

        def run(params, x, g, mod=mod):
            y, vjp = jax.vjp(lambda pp, xx: mod.apply({"params": pp}, xx),
                             params, x)
            dp, dx = vjp(g)
            return y, dx, dp

        y, dx, dp = _smap(run, tp, (col_spec, P(), out_spec),
                          (out_spec, P(), col_spec))(
            {"weight": p["w_col"], "bias": p["b_col"]}, p["x"], g_full)
        c = n_out // tp
        for rank, out in enumerate(port):
            ry, rdx, rdw, rdb = out[f"col_{gather}"]
            sl = slice(rank * c, (rank + 1) * c)
            _close(ry, np.asarray(y) if gather else np.asarray(y)[:, sl],
                   1e-6, f"column y gather={gather}")
            _close(rdx, dx, 1e-6, "column dx")
            _close(rdw, np.asarray(dp["weight"])[sl], 1e-6, "column dW")
            _close(rdb, np.asarray(dp["bias"])[sl], 1e-6, "column db")
    r_out, r_in = p["w_row"].shape
    row_spec = {"weight": P(None, "tp"), "bias": P()}
    for parallel in (True, False):
        mod = jlayers.RowParallelLinear(r_in, r_out,
                                        input_is_parallel=parallel,
                                        axis_name="tp")
        x_spec = P(None, "tp") if parallel else P()

        def run(params, x, g, mod=mod):
            y, vjp = jax.vjp(lambda pp, xx: mod.apply({"params": pp}, xx),
                             params, x)
            dp, dx = vjp(g)
            return y, dx, dp

        y, dx, dp = _smap(run, tp, (row_spec, x_spec, P()),
                          (P(), x_spec, row_spec))(
            {"weight": p["w_row"], "bias": p["b_row"]}, p["x_row"],
            p["g_row"])
        c = r_in // tp
        for rank, out in enumerate(port):
            ry, rdx, rdw, rdb = out[f"row_{parallel}"]
            sl = slice(rank * c, (rank + 1) * c)
            _close(ry, y, 1e-6, f"row y parallel={parallel}")
            _close(rdx, np.asarray(dx)[:, sl] if parallel else dx, 1e-6,
                   "row dx")
            _close(rdw, np.asarray(dp["weight"])[:, sl], 1e-6, "row dW")
            _close(rdb, dp["bias"], 1e-6, "row db")
    v, h = p["table"].shape
    emb = jlayers.VocabParallelEmbedding(v, h, axis_name="tp")

    def run(params, ids, g):
        y, vjp = jax.vjp(lambda pp: emb.apply({"params": pp}, ids), params)
        return y, vjp(g)[0]

    y, dp = _smap(run, tp, ({"weight": P("tp", None)}, P(), P()),
                  (P(), {"weight": P("tp", None)}))(
        {"weight": p["table"]}, p["ids"], p["g_emb"])
    for rank, out in enumerate(port):
        ry, rdw = out["embedding"]
        _close(ry, y, 1e-6, "embedding y")
        _close(rdw, np.asarray(dp["weight"])[rank * v // tp:
                                             (rank + 1) * v // tp],
               1e-6, "embedding dW")


# ------------------------------ GPT model -----------------------------------

def _jax_config(fused):
    return JConfig(**KW, fused_lm_head=fused, fused_lm_head_interpret=fused)


def _batch():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, KW["vocab_size"], (B, S)).astype(np.int32)
    labels = rs.randint(0, KW["vocab_size"], (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return ids, pos, labels


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(tree, tp):
    """The JAX model's own ``in_specs``: the axis along which the local
    shape of each parameter its init draws at ``tp`` differs from the
    full one."""
    ids, pos, _ = _batch()
    model = JGPT(_jax_config(False))
    local = jax.eval_shape(jax.shard_map(
        lambda i, q: model.init(jax.random.PRNGKey(0), i, q, None)["params"],
        mesh=_mesh(tp), in_specs=(P(), P()), out_specs=P(),
        check_vma=False), ids, pos)

    def spec(full, loc):
        axes = [None] * full.ndim
        for a, (f, l_) in enumerate(zip(full.shape, loc.shape)):
            if f != l_:
                assert f == l_ * tp
                axes[a] = "tp"
        return P(*axes)

    return jax.tree_util.tree_map(spec, tree, local)


@pytest.fixture(scope="module")
def gpt():
    """The JAX tree, JAX's loss and gradients at tp = 2 for both heads,
    its 3-step trajectory (fused head) with the forced overflow left to
    the port, and the port's two ranks on the same tree."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        tree = jax.tree_util.tree_map(
            np.asarray, jserving.init_gpt_params(_jax_config(False)))
        specs = _specs(tree, 2)
        ids, pos, labels = _batch()
        jax_out = {}
        for name, fused in HEADS.items():
            jm = JGPT(_jax_config(fused))
            calls = []
            sharded = xent_pallas.linear_cross_entropy_sharded
            mp.setattr(xent_pallas, "linear_cross_entropy_sharded",
                       lambda *a, _f=sharded, **k: calls.append(1)
                       or _f(*a, **k))

            def run(p, i, q, lab, jm=jm):
                def loss_fn(pp):
                    per_tok = jm.apply({"params": pp}, i, q, None, lab)
                    return jnp.mean(per_tok), per_tok
                (_, per_tok), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(p)
                return per_tok, grads

            per_tok, grads = _smap(run, 2, (specs, P(), P(), P()),
                                   (P(), specs))(tree, ids, pos, labels)
            mp.setattr(xent_pallas, "linear_cross_entropy_sharded", sharded)
            # the sharded Pallas head ran (traced once) with the fused head
            assert bool(calls) == fused, (name, calls)
            jax_out[name] = (np.asarray(per_tok), _flat(grads))
        jm = JGPT(_jax_config(True))
        js, jtx = JGradScaler(axis_names=("tp",)), jfused_adam(LR)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt, ss = jtx.init(params), js.init()
        opt_spec = type(opt)(P(), specs, specs)
        step = _smap(lambda *a: bench.make_one_step(jm, js, jtx)(*a)[:4], 2,
                     (specs, opt_spec, P(), P(), P(), P()),
                     (specs, opt_spec, P(), P()))
        losses = []
        for _ in range(STEPS):
            params, opt, ss, loss = step(params, opt, ss, ids, pos, labels)
            losses.append(float(loss))
        jax_out["train"] = (losses, _flat(params))
    port = tp_workers.run_ranks(tp_workers.gpt_case, 2, dict(
        tree=tree, ids=ids, pos=pos, labels=labels, lr=LR, steps=STEPS,
        train="fused",
        configs={name: dict(KW, fused_lm_head=fused)
                 for name, fused in HEADS.items()}))
    return tree, jax_out, port


def _cfg(**kw):
    return TransformerConfig(**dict(KW, **kw))


def _rank_slices(flat_full, rank, tp, fused=False):
    """Rank ``rank``'s slices of a flat dict of full parameter-shaped
    arrays, by the port's converter."""
    tree = {}
    for name, a in flat_full.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    sharded = tweights.shard_param_tree(tree, _cfg(fused_lm_head=fused),
                                        rank, tp)
    return _flat(jax.tree_util.tree_map(np.asarray, sharded))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_gpt_loss_and_every_gradient_match_jax_at_tp2(gpt, head):
    _, jax_out, port = gpt
    per_tok_j, grads_j = jax_out[head]
    for rank, out in enumerate(port):
        got = out[head]
        assert got["heads"] == [head], got["heads"]
        _close(got["per_tok"], per_tok_j, 1e-4, f"per_tok rank {rank}")
        want = _rank_slices(grads_j, rank, 2)
        assert set(got["grads"]) == set(want)
        for name, g in got["grads"].items():
            _close(g, want[name], 1e-4, f"{name} rank {rank}")


@pytest.mark.parametrize("head", sorted(HEADS))
def test_replicated_gradients_are_equal_on_every_rank(gpt, head):
    _, _, port = gpt
    grads = [out[head]["grads"] for out in port]
    replicated = [n for n in grads[0]
                  if tweights.shard_axis(n.replace(".", "/")) is None]
    assert "embedding.position_embeddings" in replicated
    assert "transformer.layer_0.mlp.dense_4h_to_h.bias" in replicated
    for name in replicated:
        assert np.array_equal(grads[0][name], grads[1][name]), name


def test_train_steps_match_jax_and_an_overflow_on_one_rank_skips_all(gpt):
    tree, jax_out, port = gpt
    losses_j, params_j = jax_out["train"]
    for rank, out in enumerate(port):
        train = out["train"]
        for jl, tl in zip(losses_j, train["losses"]):
            assert abs(jl - tl) <= 1e-5 * abs(jl), (rank, losses_j,
                                                    train["losses"])
        want = _rank_slices(params_j, rank, 2)
        init = _rank_slices(_flat(tree), rank, 2)
        for name, a in train["params"].items():
            # each parameter's total update, by relative L2 (the key part
            # of a qkv bias has a zero analytic gradient, which Adam turns
            # into steps of about lr of either sign; test_torch_training)
            got, ref = a - init[name], want[name] - init[name]
            err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert err <= 5e-3, (rank, name, err)
        # rank 1 alone saw an infinite gradient; both ranks skipped
        assert train["overflow"] and train["skipped"], train
        assert train["scale_after_overflow"] == train["loss_scale"] / 2
    assert losses_j[-1] < losses_j[0]


def test_port_tp2_matches_its_own_tp1_on_one_seed():
    seed = 5
    ids, pos, labels = _batch()
    kw = dict(KW, fused_lm_head=True)
    port = tp_workers.run_ranks(tp_workers.seed_case, 2, dict(
        kw=kw, seed=seed, ids=ids, pos=pos, labels=labels))
    model = GPTModel(_cfg(fused_lm_head=True), device="cpu", seed=seed)
    tids, tpos, tlabels = (torch.from_numpy(a).long()
                           for a in (ids, pos, labels))
    per_tok = model(tids, tpos, None, tlabels)
    per_tok.mean().backward()
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for rank, out in enumerate(port):
        want_p = _rank_slices(params, rank, 2, fused=True)
        for name, a in out["params"].items():
            assert np.array_equal(a, want_p[name]), name
        _close(out["per_tok"], per_tok.detach().numpy(), 1e-5, "per_tok")
        want_g = _rank_slices(grads, rank, 2, fused=True)
        for name, g in out["grads"].items():
            _close(g, want_g[name], 1e-5, name)


def test_parallel_state_groups_at_tp_2_in_a_world_of_4():
    """Two tp groups of consecutive ranks; the reduce-from mapping sums
    over its own group, in place on a non-leaf input, and its backward is
    the identity; at tp = world the default group is the tp group."""
    out = tp_workers.run_ranks(tp_workers.groups_case, 4, {})
    for rank, o in enumerate(out):
        assert o["group"] == (2, rank % 2, rank - rank % 2)
        assert o["sum"] == (3.0 if rank < 2 else 7.0) * 2.0
        assert o["in_place"] and o["grad"] == 2.0
        assert o["world_is_tp"]


def test_tp_path_refuses_a_plain_scaler_and_a_mismatched_size():
    errors = tp_workers.run_ranks(tp_workers.refusal_case, 2,
                                  dict(kw=dict(KW, num_layers=1)))
    for err in errors:
        assert "GradScaler" in err[0]
        assert "tensor-parallel" in err[1]


def test_attention_dropout_seed_differs_across_ranks_and_keeps_rank_0():
    """The seed of rank r mixes r into one shared draw (JAX folds the rank
    into the key, ``tests/test_transformer_models.py:478``): four ranks
    give four seeds, rank 0 the plain draw, and every rank's generator
    ends in the same state."""
    derive = standalone_transformer_lm.derive_attention_dropout_seed
    plain = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(11))
    seeds, states = [], []
    for rank in range(4):
        gen = torch.Generator().manual_seed(11)
        seed = derive(gen, rank)
        assert seed.dtype == torch.int32 and seed.shape == (1,)
        seeds.append(seed.item())
        states.append(gen.get_state())
    assert seeds[0] == plain.item()
    assert len(set(seeds)) == 4, seeds
    assert all(torch.equal(s, states[0]) for s in states)


def test_pad_vocab_size_is_the_jax_one():
    from apex_tpu.transformer.testing.arguments import MegatronArgs

    from apex_tpu_torch.transformer.testing.arguments import pad_vocab_size

    for tp in (1, 2, 4, 8):
        for mult in (128, 64):
            args = MegatronArgs(tensor_model_parallel_size=tp,
                                make_vocab_size_divisible_by=mult)
            for v in (50257, 512, 30522, 128):
                assert pad_vocab_size(v, tp, mult) == args.pad_vocab_size(v)
    assert pad_vocab_size(50257, 2) == 50432
    assert (50432 // 2) % 128 == 0
