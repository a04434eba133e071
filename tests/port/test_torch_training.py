"""Port parity of the training slice: ``apex_tpu_torch``'s GPTModel,
cross entropy, loss scaler, fused Adam and ``make_one_step`` against the
JAX package's on one set of weights (the JAX ``GPTModel`` init, carried
across by ``from_jax_params`` + ``load_param_tree``) and the same numpy
inputs.

The JAX model is pinned to the configuration the port models:
``fused_lm_head=False``, ``recompute_granularity="none"``, and
``APEX_DISPATCH=off`` so that no dispatch-table entry reroutes it (on the
CPU it then runs dense attention and the jnp layer norm, the functions
the port's plain versions follow).

Tolerances: per-token loss, logits and every gradient in fp32 within
1e-4 of each tensor's largest magnitude (the same fp32 math; sums over
tokens, vocab and hidden in another order); Adam and the scaler state
machine within 1e-6 relative (the same fp32 elementwise ops; ``pow`` may
differ by an ulp); a 24-step fp32 trajectory with losses within 1e-5
relative (measured 1.8e-7), and each parameter's total update and each
Adam moment within 5e-3 in relative L2 norm (measured worst 7.7e-4, at
layer_0's qkv bias). Not elementwise, and not tighter: the key part of
each qkv bias has an analytic gradient of zero (softmax ignores a shift
shared by a row's scores), so its fp32 gradient is rounding noise that
Adam normalizes into steps of about lr with either sign on either side.
The forced-overflow step (an infinite loss scale) is skipped
bit-exactly on both sides. bf16 losses within 2e-3 (measured 2.1e-4;
bf16 rounds at other places in the two frameworks: JAX keeps fp32
cotangents across casts that torch rounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bench
from apex_tpu.amp.scaler import LossScaler as JScaler
from apex_tpu.amp.scaler import LossScalerState as JScalerState
from apex_tpu.optimizers.fused_adam import fused_adam as jfused_adam
from apex_tpu.serving import model as jserving
from apex_tpu.transformer.parallel_state import TENSOR_AXIS
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jxent,
)
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch.amp import LossScaler, LossScalerState
from apex_tpu_torch.optimizers import FusedAdamState, fused_adam
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.train_step import make_one_step
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing import GPTModel
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

torch.set_num_threads(2)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=128, max_position_embeddings=32, hidden_dropout=0.0,
          attention_dropout=0.0, fused_lm_head=False,
          recompute_granularity="none")
B, S = 2, 16


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")


@pytest.fixture(scope="module")
def jax_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        return jax.tree_util.tree_map(
            np.asarray, jserving.init_gpt_params(JConfig(**KW)))


def _shmap(f, n):
    mesh = Mesh(np.asarray(jax.devices()[:1]), (TENSOR_AXIS,))
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(),) * n,
                                 out_specs=P(), check_vma=False))


def _batch(seed=0, kw=KW):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, kw["vocab_size"], (B, S)).astype(np.int32)
    labels = rs.randint(0, kw["vocab_size"], (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return ids, pos, labels


def _jax_config(kw=KW, bf16=False):
    """The JAX configuration of ``kw``; a fused head runs its Pallas
    kernel in interpret mode on the CPU."""
    return JConfig(**kw, bf16=bf16,
                   fused_lm_head_interpret=bool(kw.get("fused_lm_head")))


def _torch_model(tree, bf16=False, kw=KW):
    cfg = TConfig(**kw, bf16=bf16)
    model = GPTModel(cfg, device="cpu")
    tweights.load_param_tree(model, tweights.from_jax_params(tree, cfg,
                                                             "cpu"))
    return model


def _tt(*arrays):
    return [torch.from_numpy(np.array(a)).long() for a in arrays]


def _flat_jax(tree):
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_scaled(got, want, rel, name=""):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    atol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def test_converter_round_trip_through_gpt_model(jax_tree):
    model = _torch_model(jax_tree)
    flat = _flat_jax(jax_tree)
    assert set(model.state_dict()) == set(flat)
    assert "transformer.layer_0.self_attention.query_key_value.weight" \
        in flat and "word_embeddings" in flat
    back = tweights.to_numpy_tree(tweights.param_tree(model))
    for name, a in _flat_jax(back).items():
        assert a.dtype == flat[name].dtype and a.shape == flat[name].shape
        assert np.array_equal(a.view(np.uint32), flat[name].view(np.uint32))
    direct = GPTModel(TConfig(**KW), device="cpu", seed=1)
    tweights.load_param_tree(direct, jax_tree)        # numpy leaves
    for name, p in direct.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[name]), name
    bad = dict(jax_tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        tweights.load_param_tree(direct, bad)


def test_loss_logits_and_every_gradient_match_jax_fp32(jax_tree):
    ids, pos, labels = _batch()
    jm = JGPT(JConfig(**KW))
    per_tok_j = _shmap(lambda p, i, q, lab: jm.apply(
        {"params": p}, i, q, None, lab), 4)(jax_tree, ids, pos, labels)
    logits_j = _shmap(lambda p, i, q: jm.apply({"params": p}, i, q, None),
                      3)(jax_tree, ids, pos)
    loss_j, grads_j = _shmap(lambda p, i, q, lab: jax.value_and_grad(
        lambda p_: jnp.mean(jm.apply({"params": p_}, i, q, None, lab)))(p),
        4)(jax_tree, ids, pos, labels)

    model = _torch_model(jax_tree)
    tids, tpos, tlabels = _tt(ids, pos, labels)
    per_tok = model(tids, tpos, None, tlabels)
    assert per_tok.shape == (B, S) and per_tok.dtype == torch.float32
    loss = per_tok.mean()
    loss.backward()
    _close_scaled(per_tok, per_tok_j, 1e-4, "per_tok")
    _close_scaled(loss, loss_j, 1e-5, "loss")
    with torch.no_grad():
        _close_scaled(model(tids, tpos), logits_j, 1e-4, "logits")
    flat = _flat_jax(grads_j)
    for name, p in model.named_parameters():
        _close_scaled(p.grad, flat[name], 1e-4, name)


def test_head_dim_80_matches_jax_fp32():
    """GPT-3 2.7B's head dim (80, hidden 160 over two heads here): the
    port's loss and every gradient against the JAX model, fp32 within
    1e-4. On the card its attention runs zero-padded to 128."""
    kw = dict(KW, hidden_size=160, num_attention_heads=2)
    assert TConfig(**kw).head_dim == 80
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        tree = jax.tree_util.tree_map(
            np.asarray, jserving.init_gpt_params(JConfig(**kw)))
    ids, pos, labels = _batch(kw=kw)
    jm = JGPT(JConfig(**kw))
    loss_j, grads_j = _shmap(lambda p, i, q, lab: jax.value_and_grad(
        lambda p_: jnp.mean(jm.apply({"params": p_}, i, q, None, lab)))(p),
        4)(tree, ids, pos, labels)
    model = _torch_model(tree, kw=kw)
    loss = model(*_tt(ids, pos), None, _tt(labels)[0]).mean()
    loss.backward()
    _close_scaled(loss, loss_j, 1e-5, "loss")
    flat = _flat_jax(grads_j)
    for name, p in model.named_parameters():
        _close_scaled(p.grad, flat[name], 1e-4, name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype, smoothing):
    rs = np.random.RandomState(4)
    logits = (rs.randn(2, 5, 37) * 3).astype(np.float32)
    target = rs.randint(0, 37, (2, 5)).astype(np.int32)
    g = rs.randn(2, 5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def f(x, t, gg):
        loss, vjp = jax.vjp(lambda x_: jxent(x_, t, smoothing), x)
        return loss, vjp(gg)[0]

    loss_j, grad_j = _shmap(f, 3)(jnp.asarray(logits, jdt), target, g)
    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    loss = vocab_parallel_cross_entropy(x, torch.from_numpy(target),
                                        smoothing)
    loss.backward(torch.from_numpy(g))
    assert loss.dtype == torch.float32 and x.grad.dtype == tdt
    _close_scaled(loss, loss_j, 1e-6)
    _close_scaled(x.grad, grad_j, 1e-6 if dtype == "float32" else 1e-2)


def _scaler_states_equal(js, ts):
    assert np.float32(js.loss_scale) == ts.loss_scale.item()
    assert int(js.unskipped) == ts.unskipped.item()
    assert bool(js.overflow) == ts.overflow.item()
    assert ts.loss_scale.dtype == torch.float32
    assert ts.unskipped.dtype == torch.int32


@pytest.mark.parametrize("kw", [
    dict(scale_window=3, min_loss_scale=2.0, max_loss_scale=2.0 ** 18),
    dict(init_scale=2.0 ** 17, scale_window=2, max_loss_scale=2.0 ** 18,
         backoff_factor=0.25),
    dict(loss_scale=128.0)])
def test_scaler_state_machine_matches_jax(kw):
    flags = [False] * 4 + [True] + [False] * 6 + [True] * 20 + [False] * 3
    js, ts = JScaler(**kw), LossScaler(**kw)
    jstate, tstate = js.init(), ts.init("cpu")
    _scaler_states_equal(jstate, tstate)
    for f in flags:
        jstate = js.update(jstate, jnp.asarray(f))
        tstate = ts.update(tstate, torch.tensor(f))
        _scaler_states_equal(jstate, tstate)
    rs = np.random.RandomState(5)
    grads = {"a": rs.randn(3, 4).astype(np.float32),
             "b": rs.randn(7).astype(np.float32)}
    for poison in (None, np.inf, np.nan):
        g = {k: v.copy() for k, v in grads.items()}
        if poison is not None:
            g["b"][2] = poison
        ju, jinf = js.unscale({k: jnp.asarray(v) for k, v in g.items()},
                              jstate)
        tu, tinf = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()},
                              tstate)
        assert bool(jinf) == tinf.item() == (poison is not None)
        for k in g:
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
    d = ts.state_dict(tstate)
    back = ts.load_state_dict(ts.init("cpu"), d)
    assert back.loss_scale.item() == tstate.loss_scale.item()
    assert back.unskipped.item() == tstate.unskipped.item()
    again = LossScalerState.from_numpy(np.asarray(jstate.loss_scale),
                                       np.asarray(jstate.unskipped),
                                       np.asarray(jstate.overflow), "cpu")
    _scaler_states_equal(jstate, again)


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3, weight_decay=0.01),
    dict(learning_rate=1e-2, weight_decay=0.01, adam_w_mode=False),
    dict(learning_rate=1e-3, bias_correction=False, betas=(0.8, 0.99)),
    dict(learning_rate=lambda c: 1e-3 / c)])
def test_fused_adam_matches_jax(kw):
    rs = np.random.RandomState(6)
    params = {"a": {"w": rs.randn(3, 4).astype(np.float32)},
              "b": rs.randn(5).astype(np.float32)}
    jtx, ttx = jfused_adam(**kw), fused_adam(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {n: torch.from_numpy(a.copy()) for n, a in _flat_jax(params).items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(4):
        grads = jax.tree_util.tree_map(
            lambda a: rs.randn(*a.shape).astype(np.float32), params)
        ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tg = {n: torch.from_numpy(a) for n, a in _flat_jax(grads).items()}
        tu, tstate = ttx.update(tg, tstate, tp)
        tp = {n: tp[n] + tu[n] for n in tp}
    assert int(jstate.count) == tstate.count.item() == 4
    for tree, got in ((jp, tp), (jstate.m, tstate.m), (jstate.v, tstate.v)):
        for name, want in _flat_jax(tree).items():
            np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-6,
                                       atol=1e-9)
    back = FusedAdamState.from_numpy(
        np.asarray(jstate.count),
        jax.tree_util.tree_map(np.asarray, jstate.m),
        jax.tree_util.tree_map(np.asarray, jstate.v), "cpu")
    for name, want in _flat_jax(jstate.v).items():
        assert np.array_equal(back.v[name].numpy(), want)


def _run_trajectory(jax_tree, bf16, steps, forced=None, lr=1e-3, kw=KW):
    """Both steps side by side from the same weights and batch, for the
    configuration ``kw``; returns the per-step losses, the final states
    and the forced step's checks."""
    jm = JGPT(_jax_config(kw, bf16))
    js, jtx = JScaler(), jfused_adam(learning_rate=lr)
    jstep = _shmap(lambda *a: bench.make_one_step(jm, js, jtx)(*a)[:4], 6)
    ids, pos, labels = _batch(kw=kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    jopt, jss = jtx.init(jparams), js.init()

    model = _torch_model(jax_tree, bf16, kw)
    ts, ttx = LossScaler(), fused_adam(learning_rate=lr)
    tstep = make_one_step(model, ts, ttx)
    topt = ttx.init(dict(model.named_parameters()))
    tss = ts.init("cpu")
    tids, tpos, tlabels = _tt(ids, pos, labels)

    losses = []
    for i in range(steps):
        if i == forced:
            # an infinite loss scale: the scaled loss and every gradient
            # overflow on both sides (a finite 3e38 overflows only inside
            # the JAX CPU reference's autodiff of its jnp layer norm; the
            # port's closed-form backward keeps max|grad| * 3e38 finite)
            jss = JScalerState(loss_scale=jnp.float32(np.inf),
                               unskipped=jss.unskipped, overflow=jss.overflow)
            tss = ts.load_state_dict(tss, {"loss_scale": np.inf,
                                           "unskipped": tss.unskipped})
            before_t = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
            before_j = _flat_jax(jparams)
            count_before = (int(jopt.count), topt.count.item())
        jparams, jopt, jss, jloss = jstep(jparams, jopt, jss, ids, pos,
                                          labels)
        topt, tss, tloss = tstep(topt, tss, tids, tpos, tlabels)
        losses.append((float(jloss), tloss.item()))
        if i == forced:
            for js_state, t_state in ((jss, tss),):
                _scaler_states_equal(js_state, t_state)
            assert bool(jss.overflow) and tss.overflow.item()
            assert float(jss.loss_scale) == np.inf * 0.5   # backoff of inf
            assert int(jss.unskipped) == 0
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), before_t[n]), n
            for n, a in _flat_jax(jparams).items():
                assert np.array_equal(a, before_j[n]), n
            assert (int(jopt.count), topt.count.item()) == count_before
            # back to the default scale on both sides
            jss = JScalerState(loss_scale=jnp.float32(2.0 ** 16),
                               unskipped=jss.unskipped, overflow=jss.overflow)
            tss = ts.load_state_dict(tss, {"loss_scale": 2.0 ** 16,
                                           "unskipped": tss.unskipped})
    return losses, (jparams, jopt, jss), (model, topt, tss)


def test_trajectory_matches_jax_bench_step_with_a_skipped_overflow(jax_tree):
    steps, forced = 24, 9
    losses, (jparams, jopt, jss), (model, topt, tss) = _run_trajectory(
        jax_tree, False, steps, forced)
    for i, (jl, tl) in enumerate(losses):
        if i == forced:        # inf / inf: the unscaled loss is NaN
            assert np.isnan(jl) and np.isnan(tl)
        else:
            assert abs(jl - tl) <= 1e-5 * abs(jl), (i, jl, tl)
    finite = [jl for i, (jl, _) in enumerate(losses) if i != forced]
    assert finite[-1] < finite[0]
    _scaler_states_equal(jss, tss)
    assert int(jopt.count) == topt.count.item() == steps - 1
    params = dict(model.named_parameters())
    init = _flat_jax(jax_tree)
    for tree, got, base in ((jparams, params, init), (jopt.m, topt.m, None),
                            (jopt.v, topt.v, None)):
        for name, want in _flat_jax(tree).items():
            # the parameters through their total update from the init
            g = got[name].detach().numpy() - (0 if base is None
                                              else base[name])
            w = want - (0 if base is None else base[name])
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 5e-3, (name, err)


def test_bf16_trajectory_stays_within_the_band(jax_tree):
    losses, _, (model, _, _) = _run_trajectory(jax_tree, True, 6)
    for jl, tl in losses:
        assert abs(jl - tl) <= 2e-3, losses
    assert losses[-1][1] < losses[0][1]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_step_never_reads_a_device_value_on_the_host(jax_tree, monkeypatch):
    model = _torch_model(jax_tree, bf16=True)
    ts, ttx = LossScaler(), fused_adam(1e-3)
    step = make_one_step(model, ts, ttx)
    opt, ss = ttx.init(dict(model.named_parameters())), ts.init("cpu")
    tids, tpos, tlabels = _tt(*_batch())

    def refuse(*_a, **_k):
        raise AssertionError("the step read a tensor's value on the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    opt, ss, loss = step(opt, ss, tids, tpos, tlabels)
    monkeypatch.undo()
    assert torch.isfinite(loss).item() and opt.count.item() == 1


@pytest.mark.parametrize("change,match", [
    (dict(recompute_granularity="layer"), "recompute"),
    (dict(num_moe_experts=4), "MoE"),
    (dict(sequence_parallel=True), "sequence"),
])
def test_gpt_model_refuses_what_the_slice_does_not_model(change, match):
    with pytest.raises(ValueError, match=match):
        GPTModel(TConfig(**dict(KW, **change)), device="cpu")


def test_gpt_model_refuses_tp_dropout_and_masks():
    with pytest.raises(ValueError, match="tensor-parallel"):
        GPTModel(TConfig(**KW), device="cpu", tp_size=2)
    model = GPTModel(TConfig(**dict(KW, hidden_dropout=0.1)), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="dropout"):
        model(ids, pos, None, ids, deterministic=False)
    model(ids, pos, None, ids)                 # deterministic: no dropout
    # an explicit mask runs: the scores path, whose unfused softmax ORs it
    # with the causal triangle (its JAX parity is in test_torch_bert.py)
    mask = torch.zeros(1, 1, 4, 4, dtype=torch.bool)
    with torch.no_grad():
        assert torch.allclose(model(ids, pos, mask), model(ids, pos),
                              atol=1e-6)
        masked = model(ids, pos, torch.ones(1, 1, 4, 4, dtype=torch.bool))
    assert torch.isfinite(masked).all()
    assert not torch.allclose(masked, model(ids, pos), atol=1e-6)
