"""Port parity of the optimizers: ``apex_tpu_torch.optimizers`` against
``apex_tpu.optimizers`` on the same seeded numpy parameters and gradients,
on the CPU: each transform over ``tests/test_fused_optimizers.py``'s grid
of options (Adam L2/AdamW; SGD momentum, Nesterov, decay, dampening; LAMB
two_pass and one_pass with and without decay, clipping and NVLAMB;
NovoGrad norm_type 0/2, reg_inside_moment, init_zero; Adagrad;
mixed-precision LAMB in bf16), the in-place fused form against the
functional update, the class API with param groups and an lr change
between steps, every state loaded from JAX's through ``from_numpy``, the
LAMB structure knob, and a tiny GPT trained by ``make_one_step`` with
``fused_lamb`` against ``bench.make_one_step(..., fused_lamb(...))``
through a forced overflow.

Tolerances (relative to each tensor's largest magnitude): fp32 1e-6 (the
same fp32 elementwise ops; ``pow`` may differ by an ulp, and NovoGrad's
per-tensor norms sum in another order), LAMB 1e-5 (its norms and the
global clip sum in another order, and the trust ratio carries those
differences into every element); the in-place form equals the functional
update bit for bit (the same ops); mixed-precision LAMB's fp32 masters
within 1e-5 and its bf16 parameters within one bf16 ulp (2^-7 relative:
a master a few ulps apart may round the other way); the GPT trajectory's
losses within 1e-5 relative, and the skipped step bitwise unchanged on
both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import test_torch_training as training
from apex_tpu.amp.scaler import LossScaler as JScaler
from apex_tpu.amp.scaler import LossScalerState as JScalerState
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.train_step import make_one_step

# the modules (the packages' attributes of these names are the functions)
jadagrad, jadam, jlamb, jmplamb, jnovograd, jsgd = (
    importlib.import_module(f"apex_tpu.optimizers.{m}") for m in (
        "fused_adagrad", "fused_adam", "fused_lamb",
        "fused_mixed_precision_lamb", "fused_novograd", "fused_sgd"))
tlamb, tmplamb, tsgd = (
    importlib.import_module(f"apex_tpu_torch.optimizers.{m}") for m in (
        "fused_lamb", "fused_mixed_precision_lamb", "fused_sgd"))

# name: (JAX transform, port transform, port state class, tolerance)
OPTS = {
    "adam": (jadam.fused_adam, topt.fused_adam, topt.FusedAdamState, 1e-6),
    "sgd": (jsgd.fused_sgd, topt.fused_sgd, topt.FusedSGDState, 1e-6),
    "lamb": (jlamb.fused_lamb, topt.fused_lamb, topt.FusedLAMBState, 1e-5),
    "novograd": (jnovograd.fused_novograd, topt.fused_novograd,
                 topt.FusedNovoGradState, 1e-6),
    "adagrad": (jadagrad.fused_adagrad, topt.fused_adagrad,
                topt.FusedAdagradState, 1e-6),
}
LAMB_KW = [dict(), dict(adam_w_mode=False), dict(weight_decay=0.0),
           dict(weight_decay=0.0, use_nvlamb=True), dict(max_grad_norm=0.0),
           dict(bias_correction=False, grad_averaging=False)]
CASES = (
    [("adam", dict(learning_rate=1e-3)),
     ("adam", dict(learning_rate=1e-2, weight_decay=0.1)),
     ("adam", dict(learning_rate=1e-2, weight_decay=0.1, adam_w_mode=False)),
     ("adam", dict(learning_rate=1e-3, bias_correction=False,
                   betas=(0.8, 0.99))),
     ("adam", dict(learning_rate="schedule")),
     ("sgd", dict(learning_rate=0.1)),
     ("sgd", dict(learning_rate=0.1, momentum=0.9)),
     ("sgd", dict(learning_rate=0.1, momentum=0.9, nesterov=True)),
     ("sgd", dict(learning_rate=0.1, momentum=0.9, weight_decay=0.05)),
     ("sgd", dict(learning_rate=0.1, momentum=0.9, dampening=0.1))]
    + [("lamb", dict(kw, learning_rate=1e-2, impl=impl))
       for impl in ("two_pass", "one_pass") for kw in LAMB_KW]
    + [("lamb", dict(learning_rate="schedule", impl="two_pass"))]
    + [("novograd", dict(learning_rate=1e-2, weight_decay=0.01,
                         norm_type=nt, reg_inside_moment=reg))
       for nt in (2, 0) for reg in (False, True)]
    + [("novograd", dict(learning_rate=1e-2, init_zero=True))]
    + [("adagrad", dict(learning_rate=0.1)),
       ("adagrad", dict(learning_rate=0.1, weight_decay=0.01)),
       ("adagrad", dict(learning_rate=0.1, weight_decay=0.01,
                        adagrad_w_mode=True))])


def _case_id(case):
    name, kw = case
    return name + "-" + "-".join(f"{k}={v}" for k, v in sorted(kw.items()))


def _params(seed=0):
    """A nested JAX-style tree of fp32 host arrays (JAX flattens it in
    sorted key order, the order of :func:`_flat`)."""
    rs = np.random.RandomState(seed)
    return {"a": {"w": rs.randn(6, 9).astype(np.float32),
                  "b": rs.randn(17).astype(np.float32)},
            "c": rs.randn(2, 3, 4).astype(np.float32),
            "d": rs.randn(5).astype(np.float32)}


def _grads(rs, params, scale=1.0):
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * scale).astype(np.float32), params)


_flat = training._flat_jax


def _lr(value, jax_side):
    if value != "schedule":
        return value
    if jax_side:
        return lambda c: 1e-2 * jnp.minimum(c / 3.0, 1.0)
    return lambda c: 1e-2 * torch.clamp(c / 3.0, max=1.0)


def _transforms(case):
    name, kw = case
    jfn, tfn, _, tol = OPTS[name]
    jkw = dict(kw, learning_rate=_lr(kw["learning_rate"], True))
    tkw = dict(kw, learning_rate=_lr(kw["learning_rate"], False))
    return jfn(**jkw), tfn(**tkw), tol


def _torch(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in _flat(tree).items()}


def _close(got, want, rel, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    atol = rel * max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _state_leaves(state):
    """A port state's tensors by field (dicts flattened)."""
    out = {}
    for f, val in vars(state).items():
        if isinstance(val, dict):
            out.update({f"{f}.{n}": t for n, t in val.items()})
        elif torch.is_tensor(val):
            out[f] = val
        else:
            out.update({f"{f}.{k}": t for k, t in _state_leaves(val).items()})
    return out


def _jax_state_leaves(state):
    out = {}
    for f, val in state._asdict().items():
        if isinstance(val, dict):
            out.update({f"{f}.{n}": a for n, a in _flat(val).items()})
        elif hasattr(val, "_asdict"):
            out.update({f"{f}.{k}": a
                        for k, a in _jax_state_leaves(val).items()})
        else:
            out[f] = np.asarray(val)
    return out


def _compare(jp, tp, jstate, tstate, tol):
    for n, want in _flat(jp).items():
        _close(tp[n], want, tol, n)
    want = _jax_state_leaves(jstate)
    got = _state_leaves(tstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if np.asarray(w).dtype == np.int32:
            assert int(got[k]) == int(w), k
        else:
            _close(got[k], w, tol, k)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_transform_matches_jax_and_its_in_place_form(case):
    """Six steps of the functional update against JAX's; the in-place
    form (``step`` where the transform has one, else the plain selects)
    gives the functional update's bits."""
    jtx, ttx, tol = _transforms(case)
    params = _params()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp, tp2 = _torch(params), _torch(params)
    js, ts, ts2 = jtx.init(jp), ttx.init(tp), ttx.init(tp2)
    rs = np.random.RandomState(1)
    for _ in range(6):
        g = _grads(rs, params)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_torch(g), ts, tp)
        tp = {n: tp[n] + tu[n].to(tp[n].dtype) for n in tp}
        if ttx.step is not None:
            ttx.step(_torch(g), ts2, tp2)
        else:
            topt._base.apply_plain(ttx.update, _torch(g), ts2, tp2)
    _compare(jp, tp, js, ts, tol)
    for n in tp:
        assert torch.equal(tp[n], tp2[n]), n
    for k, t in _state_leaves(ts).items():
        assert torch.equal(t, _state_leaves(ts2)[k]), k


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_loads_from_jax_and_steps_on(name):
    """JAX's state after three steps, through ``from_numpy``, then two
    more steps on both sides."""
    case = next(c for c in CASES if c[0] == name)
    jtx, ttx, tol = _transforms(case)
    params = _params(2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jtx.init(jp)
    rs = np.random.RandomState(3)
    for _ in range(3):
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray,
                                                   _grads(rs, params)), js, jp)
        jp = optax.apply_updates(jp, ju)
    host = jax.tree_util.tree_map(np.asarray, js)
    ts = OPTS[name][2].from_numpy(*host, device="cpu")
    tp = _torch(jax.tree_util.tree_map(np.asarray, jp))
    _compare(jp, tp, js, ts, 0.0)
    for _ in range(2):
        g = _grads(rs, params)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_torch(g), ts, tp)
        tp = {n: tp[n] + tu[n] for n in tp}
    _compare(jp, tp, js, ts, tol)


def test_mixed_precision_lamb_matches_jax_in_bf16():
    """bf16 parameters and gradients, fp32 masters: four steps; the state
    loaded from JAX's steps on too."""
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)), _params(4))
    jtx = jmplamb.fused_mixed_precision_lamb(1e-2)
    ttx = tmplamb.fused_mixed_precision_lamb(1e-2)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    tp = {n: t.to(torch.bfloat16) for n, t in _torch(params).items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    rs = np.random.RandomState(5)
    for i in range(4):
        g = _grads(rs, params, 1e-2)
        ju, js = jtx.update(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({n: t.to(torch.bfloat16)
                             for n, t in _torch(g).items()}, ts, tp)
        tp = {n: tp[n] + tu[n] for n in tp}
        if i == 1:
            loaded = tmplamb.MixedPrecisionLambState.from_numpy(
                np.asarray(js.master_flat),
                jax.tree_util.tree_map(np.asarray, js.inner), device="cpu")
            assert torch.equal(loaded.master_flat,
                               torch.from_numpy(np.array(js.master_flat)))
    _close(ts.master_flat, np.asarray(js.master_flat), 1e-5, "masters")
    for n, want in _flat(jp).items():
        assert tp[n].dtype == torch.bfloat16
        np.testing.assert_allclose(tp[n].float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2.0 ** -7, atol=0, err_msg=n)


CLASSES = [("FusedAdam", dict(weight_decay=0.01), 1e-6),
           ("FusedLAMB", dict(), 1e-5),
           ("FusedSGD", dict(momentum=0.9), 1e-6),
           ("FusedNovoGrad", dict(weight_decay=0.01), 1e-6),
           ("FusedAdagrad", dict(), 1e-6),
           ("FusedMixedPrecisionLamb", dict(), 1e-5)]


@pytest.mark.parametrize("cls,kw,tol", CLASSES, ids=[c[0] for c in CLASSES])
def test_class_api_with_param_groups_and_an_lr_change(cls, kw, tol):
    """Two param groups (the second with its own lr), ``step()`` over
    ``p.grad`` in place, the first group's lr changed after two steps."""
    import apex_tpu.optimizers as jopts

    arrays = _flat(_params(6))
    names = list(arrays)
    split = [names[:2], names[2:]]
    jgroups = [[jnp.asarray(arrays[n]) for n in grp] for grp in split]
    tgroups = [[torch.nn.Parameter(torch.from_numpy(arrays[n].copy()))
                for n in grp] for grp in split]
    jopt = getattr(jopts, cls)([{"params": jgroups[0]},
                                {"params": jgroups[1], "lr": 0.05}],
                               lr=0.01, **kw)
    t_opt = getattr(topt, cls)([{"params": tgroups[0]},
                                {"params": tgroups[1], "lr": 0.05}],
                               lr=0.01, **kw)
    assert isinstance(t_opt, torch.optim.Optimizer)
    rs = np.random.RandomState(7)
    for i in range(4):
        if i == 2:
            jopt.param_groups[0]["lr"] = t_opt.param_groups[0]["lr"] = 0.03
        grads = [[rs.randn(*arrays[n].shape).astype(np.float32)
                  for n in grp] for grp in split]
        out = jopt.step([[jnp.asarray(g) for g in gs] for gs in grads])
        for ps, gs in zip(tgroups, grads):
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g)
        t_opt.step()
    for jps, tps in zip(out, tgroups):
        for j, t in zip(jps, tps):
            _close(t, np.asarray(j), tol, cls)
    t_opt.zero_grad()
    assert all(p.grad is None for ps in tgroups for p in ps)


def test_sgd_momentums_and_the_partial_grad_rule():
    p = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    opt = topt.FusedSGD(p, lr=0.1, momentum=0.9)
    bufs, first = opt.get_momentums()
    assert first and [b.shape for b in bufs] == [(3,), (2,)]
    assert not opt.get_momentums()[1]
    p[0].grad = torch.ones(3)
    with pytest.raises(ValueError, match="1 of 2"):
        opt.step()
    p[1].grad = torch.ones(2)
    opt.step()
    assert torch.equal(opt.get_momentums()[0][0], torch.ones(3))
    assert tsgd.get_momentums(opt.group_states[0])[1].shape == (2,)
    with pytest.raises(ValueError, match="Nesterov"):
        topt.fused_sgd(momentum=0.0, nesterov=True)
    with pytest.raises(RuntimeError, match="l2/inf"):
        topt.fused_novograd(norm_type=1)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        topt.FusedAdam(p, amsgrad=True)


def test_lamb_impl_knob_resolves_as_jax(monkeypatch):
    monkeypatch.delenv("APEX_LAMB_IMPL", raising=False)
    assert tlamb._resolve_impl(None) == "two_pass"   # JAX's table-miss seat
    monkeypatch.setenv("APEX_LAMB_IMPL", "one_pass")
    assert tlamb._resolve_impl(None) == jlamb._resolve_impl(None) \
        == "one_pass"
    assert tlamb._resolve_impl("two_pass") == "two_pass"
    with pytest.raises(ValueError):
        tlamb._resolve_impl("flat")
    monkeypatch.setenv("APEX_LAMB_IMPL", "bogus")
    for resolve in (tlamb._resolve_impl, jlamb._resolve_impl):
        with pytest.raises(ValueError):
            resolve(None)
    with pytest.raises(ValueError):
        topt.fused_lamb()


def test_fused_forms_skip_bitwise_on_a_set_flag():
    """The in-place form with the found-inf flag set writes nothing."""
    for tx in (topt.fused_adam(1e-2), topt.fused_lamb(1e-2),
               tmplamb.fused_mixed_precision_lamb(1e-2)):
        params = _torch(_params(8))
        state = tx.init(params)
        g = _torch(_grads(np.random.RandomState(9), _params(8)))
        tx.step(g, state, params)
        before_p = {n: t.clone() for n, t in params.items()}
        before_s = {k: t.clone() for k, t in _state_leaves(state).items()}
        tx.step(g, state, params, torch.tensor(True))
        for n, t in params.items():
            assert torch.equal(t, before_p[n]), n
        for k, t in _state_leaves(state).items():
            assert torch.equal(t, before_s[k]), k


def _lamb_pair(lr):
    return (jlamb.fused_lamb(learning_rate=lambda c: lr * jnp.minimum(
                c / 3.0, 1.0), eps=1e-8),
            tlamb.fused_lamb(learning_rate=lambda c: lr * torch.clamp(
                c / 3.0, max=1.0), eps=1e-8))


def test_gpt_trajectory_with_fused_lamb_matches_jax_bench_step(jax_tree):
    """``make_one_step`` with ``fused_lamb`` (pretrain.py's decay 0.01 and
    clip 1.0, a warm-up schedule on the device count) against
    ``bench.make_one_step(..., fused_lamb(...))``: 10 steps, the fifth
    forced to overflow (an infinite loss scale) and skipped bitwise on
    both sides."""
    steps, forced = 10, 4
    jtx, ttx = _lamb_pair(1e-2)
    jm = training.JGPT(training._jax_config())
    js = JScaler()
    jstep = training._shmap(
        lambda *a: bench.make_one_step(jm, js, jtx)(*a)[:4], 6)
    ids, pos, labels = training._batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    jopt, jss = jtx.init(jparams), js.init()
    model = training._torch_model(jax_tree)
    ts = LossScaler()
    tstep = make_one_step(model, ts, ttx)
    t_opt = ttx.init(dict(model.named_parameters()))
    tss = ts.init("cpu")
    tids, tpos, tlabels = training._tt(ids, pos, labels)
    losses = []
    for i in range(steps):
        if i == forced:
            jss = JScalerState(loss_scale=jnp.float32(np.inf),
                               unskipped=jss.unskipped, overflow=jss.overflow)
            tss = ts.load_state_dict(tss, {"loss_scale": np.inf,
                                           "unskipped": tss.unskipped})
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            before_state = {k: t.clone()
                            for k, t in _state_leaves(t_opt).items()}
            before_j = training._flat_jax(jparams)
        jparams, jopt, jss, jloss = jstep(jparams, jopt, jss, ids, pos,
                                          labels)
        t_opt, tss, tloss = tstep(t_opt, tss, tids, tpos, tlabels)
        losses.append((float(jloss), tloss.item()))
        if i == forced:
            assert bool(jss.overflow) and tss.overflow.item()
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
            for k, t in _state_leaves(t_opt).items():
                assert torch.equal(t, before_state[k]), k
            for n, a in training._flat_jax(jparams).items():
                assert np.array_equal(a, before_j[n]), n
            jss = JScalerState(loss_scale=jnp.float32(2.0 ** 16),
                               unskipped=jss.unskipped, overflow=jss.overflow)
            tss = ts.load_state_dict(tss, {"loss_scale": 2.0 ** 16,
                                           "unskipped": tss.unskipped})
    for i, (jl, tl) in enumerate(losses):
        if i != forced:
            assert abs(jl - tl) <= 1e-5 * abs(jl), (i, jl, tl)
    finite = [jl for i, (jl, _) in enumerate(losses) if i != forced]
    assert finite[-1] < finite[0]
    assert int(jopt.count) == t_opt.count.item() == steps - 1


@pytest.fixture(scope="module")
def jax_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        return jax.tree_util.tree_map(
            np.asarray, training.jserving.init_gpt_params(
                training.JConfig(**training.KW)))


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")
    monkeypatch.delenv("APEX_LAMB_IMPL", raising=False)
