"""Port parity of the amp frontend on the CPU: ``apex_tpu_torch.amp``
against ``apex_tpu.amp``: each opt level's ``Properties`` and every
consistency check of ``Properties.__setattr__`` (the same settings
raise the same errors), ``build_policy``, the cast lists, the cast
combinators under ``autocast``, the set of parameters ``initialize``
keeps fp32 on ResNet-50's tree (JAX's batch-norm predicate: under O2
exactly ``bn_init``'s two), ``AmpOptimizer`` over five steps with fp16
dynamic scaling, master weights and a forced overflow (SGD with the
master-to-model copy in its fused step, and Adam with the copy after),
``value_and_scaled_grad``, ``update_scaler`` with several losses, and a
``state_dict`` round trip.

Tolerance 1e-6 relative to the largest magnitude for the fp32 masters
and states (the same fp32 ops), the fp16 parameters one fp16 ulp (a
master a few fp32 ulps apart may round the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import resnet50 as jax_resnet50
from apex_tpu.optimizers.fused_adam import fused_adam as jfused_adam
from apex_tpu.optimizers.fused_sgd import fused_sgd as jfused_sgd
from apex_tpu_torch import amp
from apex_tpu_torch.amp.frontend import joined_path
from apex_tpu_torch.models import resnet50
from apex_tpu_torch.optimizers import fused_adam, fused_sgd

TORCH_OF = {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float16): torch.float16}


def _to_torch(v):
    if isinstance(v, (str, bool, float, int, torch.dtype)) or v is None:
        return v
    return TORCH_OF[jnp.dtype(v)]


def _options(props):
    return {k: _to_torch(v) for k, v in props.options.items()}


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_opt_level_properties_match_jax(level):
    want = _options(jamp.opt_levels[level](jamp.Properties()))
    assert _options(amp.opt_levels[level](amp.Properties())) == want
    assert amp.opt_levels[level].brief == jamp.opt_levels[level].brief


SETTINGS = [("cast_model_type", v) for v in
            (None, False, "half", "float32", "bfloat16", "float16")] + \
    [("patch_torch_functions", v) for v in (True, False)] + \
    [("keep_batchnorm_fp32", v) for v in (None, True, False, "True", "False",
                                          "maybe")] + \
    [("master_weights", v) for v in (None, True, False)] + \
    [("loss_scale", v) for v in ("dynamic", 128, "256.0")] + \
    [("half_dtype", "float16"), ("not_an_option", 1)]


def _value(v, lib):
    if v in ("float32", "bfloat16", "float16"):
        return getattr(jnp if lib == "jax" else torch, v)
    return v


def _outcome(props, name, value):
    try:
        setattr(props, name, value)
    except (RuntimeError, AttributeError, AssertionError, ValueError) as e:
        return type(e).__name__
    return _to_torch(props.options.get(name)) if name in props.options \
        else "set"


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("name,value", SETTINGS)
def test_properties_checks_match_jax(level, name, value):
    """Every check of ``Properties.__setattr__``: the same setting raises
    the same error, or sets the same value, under each opt level."""
    want = _outcome(jamp.opt_levels[level](jamp.Properties()), name,
                    _value(value, "jax"))
    got = _outcome(amp.opt_levels[level](amp.Properties()), name,
                   _value(value, "torch"))
    assert got == want


POLICY_CASES = [("O0", {}), ("O1", {}), ("O2", {}), ("O3", {}),
                ("O2", {"half_dtype": "float16"}),
                ("O2", {"keep_batchnorm_fp32": False}),
                ("O1", {"cast_model_type": "float32"}),
                ("O0", {"cast_model_type": "float16"}),
                ("O2", {"cast_model_type": "float32"})]


@pytest.mark.parametrize("level,over", POLICY_CASES)
def test_build_policy_matches_jax(level, over):
    out = []
    for lib, mod in (("jax", jamp), ("torch", amp)):
        props = mod.opt_levels[level](mod.Properties())
        for k, v in over.items():
            setattr(props, k, _value(v, lib))
        p = mod.build_policy(props)
        out.append((_to_torch(p.param_dtype), _to_torch(p.compute_dtype),
                    _to_torch(p.output_dtype), p.keep_batchnorm_fp32,
                    p.enabled))
    assert out[1] == out[0]


def test_cast_lists_equal_jax():
    from apex_tpu.amp import policy as jpolicy
    from apex_tpu_torch.amp import policy

    for name in ("FP16_FUNCS", "FP32_FUNCS", "CASTS", "SEQUENCE_CASTS"):
        assert getattr(policy, name) == getattr(jpolicy, name), name
    assert set(policy.BANNED_FUNCS) == set(jpolicy.BANNED_FUNCS)
    for op in sorted(jpolicy.FP16_FUNCS | jpolicy.FP32_FUNCS | jpolicy.CASTS
                     | jpolicy.SEQUENCE_CASTS) + ["unknown"]:
        assert amp.lookup_cast(op) == jamp.lookup_cast(op)
    with pytest.raises(NotImplementedError):
        amp.lookup_cast("binary_cross_entropy")


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_cast_combinators_match_jax(half):
    """half_function, float_function, promote_function and cast_for_op
    under autocast: the output dtypes of JAX's on the same inputs; no
    policy, no cast."""
    def dt(x):
        return str(x.dtype).replace("torch.", "")

    def run(lib):
        m, npd = (jamp, jnp) if lib == "jax" else (amp, torch)

        def arr(d):
            return (jnp.ones(3, getattr(jnp, d)) if lib == "jax"
                    else torch.ones(3, dtype=getattr(torch, d)))

        fns = {"half": m.half_function(lambda a, b: (a, b)),
               "float": m.float_function(lambda a, b: (a, b)),
               "promote": m.promote_function(lambda a, b: (a, b))}
        out = {}
        inputs = (arr("float32"), arr(half))
        with m.autocast(dtype=getattr(npd, half)):
            for k, f in fns.items():
                out[k] = [dt(t) for t in f(*inputs)]
            for op in ("conv2d", "softmax", "add", "cat", "unknown"):
                out[op] = [dt(t) for t in m.cast_for_op(op, *inputs)]
            out["compute"] = str(m.compute_dtype()).replace("torch.", "")
            with m.disable_casts():
                out["disabled"] = [dt(t) for t in fns["half"](*inputs)]
        out["none"] = [dt(t) for t in fns["half"](*inputs)]
        return out

    assert run("torch") == run("jax")


def _jax_flat_fp32(params, prefix=""):
    out = set()
    for k, v in params.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out |= _jax_flat_fp32(v, name)
        elif v.dtype == jnp.float32:
            out.add(name.replace(".kernel", ".weight"))
    return out


@pytest.fixture(scope="module")
def resnet50_shapes():
    model = jax_resnet50(num_classes=1000)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
        train=False))["params"]


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_initialize_keeps_jaxs_fp32_leaves_on_resnet50(level,
                                                       resnet50_shapes):
    """``initialize`` casts ResNet-50's 161 parameters as JAX's does with
    JAX's batch-norm predicate: O0 and O1 keep all fp32, O2 exactly
    ``bn_init.weight`` and ``bn_init.bias``, O3 none."""
    cast = jax.eval_shape(lambda p: jamp.initialize(p, opt_level=level,
                                                    verbosity=0),
                          resnet50_shapes)
    want = _jax_flat_fp32(cast)
    model = resnet50(device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 161
    amp.initialize(model, opt_level=level, verbosity=0)
    got = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert got == want
    if level == "O2":
        assert got == {"bn_init.weight", "bn_init.bias"}
        assert {p.dtype for n, p in model.named_parameters()
                if n not in got} == {torch.bfloat16}
    assert joined_path("stage0_block0.bn1.weight") == \
        "['stage0_block0']/['bn1']/['weight']"
    assert all(b.dtype == torch.float32 for b in model.buffers())


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_amp_optimizer_matches_jax_with_fp16_scaling_and_overflow(opt):
    """Five steps of ``AmpOptimizer`` under O2 with fp16 parameters and
    dynamic scaling, step 3's gradients non-finite: the fp16 parameters,
    fp32 masters, the inner state, the loss scale and unskipped after
    each step equal JAX's."""
    rs = np.random.RandomState(0)
    p0 = {"dense": {"kernel": rs.randn(4, 3).astype(np.float32),
                    "bias": rs.randn(3).astype(np.float32)}}
    if opt == "sgd":
        jtx = jfused_sgd(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
        ttx = fused_sgd(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    else:
        jtx, ttx = jfused_adam(1e-2), fused_adam(1e-2)
    jp, jopt = jamp.initialize(jax.tree_util.tree_map(jnp.asarray, p0), jtx,
                               opt_level="O2", half_dtype=jnp.float16,
                               verbosity=0)
    jstate = jopt.init(jp)
    model = {"dense.kernel": torch.from_numpy(p0["dense"]["kernel"]),
             "dense.bias": torch.from_numpy(p0["dense"]["bias"])}
    tp, topt = amp.initialize(model, ttx, opt_level="O2",
                              half_dtype=torch.float16, verbosity=0)
    assert tp["dense.kernel"].dtype == torch.float16
    tstate = topt.init(tp)
    assert torch.equal(tstate.master_params["dense.kernel"],
                       tp["dense.kernel"].float())
    for step in range(5):
        g = {"kernel": rs.randn(4, 3).astype(np.float32) * 1e-3,
             "bias": rs.randn(3).astype(np.float32) * 1e-3}
        if step == 2:
            g["bias"][1] = np.inf
        scale = float(jstate.scalers[0].loss_scale)
        assert tstate.scalers[0].loss_scale.item() == scale
        jg = {"dense": {k: jnp.asarray(v * scale, jnp.float16)
                        for k, v in g.items()}}
        tg = {f"dense.{k}": torch.from_numpy(v * scale).to(torch.float16)
              for k, v in g.items()}
        jp, jstate, jinfo = jopt.apply_gradients(jg, jstate, jp)
        tp, tstate, tinfo = topt.apply_gradients(tg, tstate, tp)
        assert bool(tinfo["overflow"]) == bool(jinfo["overflow"]) \
            == (step == 2)
        for k in ("kernel", "bias"):
            _close(_np(tstate.master_params[f"dense.{k}"]),
                   jstate.master_params["dense"][k])
            _close(_np(tp[f"dense.{k}"]), np.asarray(jp["dense"][k],
                                                     np.float32), 2.0 ** -10)
            assert tp[f"dense.{k}"].dtype == torch.float16
        assert tstate.scalers[0].loss_scale.item() == \
            float(jstate.scalers[0].loss_scale)
        assert tstate.scalers[0].unskipped.item() == \
            int(jstate.scalers[0].unskipped)
        assert tstate.inner.count.item() == int(jstate.inner.count)
        bufs = (tstate.inner.momentum_buf if opt == "sgd"
                else tstate.inner.m)
        jbufs = (jstate.inner.momentum_buf if opt == "sgd"
                 else jstate.inner.m)
        _close(_np(bufs["dense.kernel"]), jbufs["dense"]["kernel"])
    assert amp.master_params(tstate)[0] is \
        tstate.master_params["dense.kernel"]


def test_value_and_scaled_grad_matches_jax():
    """(loss, unscaled fp32 grads, found_inf) of a loss of fp16 parameters
    under a dynamic scale, and a zero gradient for an unused parameter."""
    rs = np.random.RandomState(1)
    w = rs.randn(4, 2).astype(np.float32)
    x = (rs.randn(3, 4) * 1e-3).astype(np.float32)   # fp16 scaled grads fit
    jp, jopt = jamp.initialize({"w": jnp.asarray(w), "u": jnp.ones(2)},
                               jfused_sgd(0.1), opt_level="O2",
                               half_dtype=jnp.float16, verbosity=0)
    jstate = jopt.init(jp)

    def jloss(p):
        return jnp.sum((jnp.asarray(x, p["w"].dtype) @ p["w"])
                       .astype(jnp.float32) ** 2)

    jl, jg, jinf = jamp.value_and_scaled_grad(jloss, jopt)(jp, jstate)
    model = {"w": torch.from_numpy(w).requires_grad_(),
             "u": torch.ones(2, requires_grad=True)}
    tp, topt = amp.initialize(model, fused_sgd(0.1), opt_level="O2",
                              half_dtype=torch.float16, verbosity=0)
    tp = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tstate = topt.init(tp)

    def tloss(p):
        return (((torch.from_numpy(x).to(p["w"].dtype) @ p["w"]).float())
                ** 2).sum()

    tl, tg, tinf = amp.value_and_scaled_grad(tloss, topt)(tp, tstate)
    _close(tl.numpy(), jl, 1e-3)
    _close(tg["w"].numpy(), jg["w"], 1e-3)
    assert tg["w"].dtype == torch.float32
    assert torch.equal(tg["u"], torch.zeros(2))
    assert bool(tinf) == bool(jinf) is False


def test_update_scaler_with_several_losses_matches_jax():
    jp, jopt = jamp.initialize({"w": jnp.ones(2)}, jfused_sgd(0.1),
                               opt_level="O2", num_losses=3, verbosity=0)
    tp, topt = amp.initialize({"w": torch.ones(2)}, fused_sgd(0.1),
                              opt_level="O2", num_losses=3, verbosity=0)
    js, ts = jopt.init(jp), topt.init(tp)
    for loss_id, inf in ((1, True), (0, False), (1, True), (2, False)):
        js = jopt.update_scaler(js, jnp.asarray(inf), loss_id)
        ts = topt.update_scaler(ts, torch.tensor(inf), loss_id)
    assert [s.loss_scale.item() for s in ts.scalers] == \
        [float(s.loss_scale) for s in js.scalers]
    assert [s.unskipped.item() for s in ts.scalers] == \
        [int(s.unskipped) for s in js.scalers]


def test_state_dict_round_trip_and_handles():
    _, topt = amp.initialize({"w": torch.ones(2)}, fused_sgd(0.1),
                             opt_level="O2", num_losses=2, verbosity=0)
    state = topt.init({"w": torch.ones(2, dtype=torch.bfloat16)})
    state = topt.update_scaler(state, torch.tensor(True), 1)
    sd = amp.state_dict([state])
    assert sd == {"loss_scaler0": {"loss_scale": 65536.0, "unskipped": 0},
                  "loss_scaler1": {"loss_scale": 32768.0, "unskipped": 0}}
    fresh = topt.init({"w": torch.ones(2, dtype=torch.bfloat16)})
    (loaded,) = amp.load_state_dict(sd, [fresh])
    assert amp.state_dict([loaded]) == sd
    assert loaded.scalers[1].overflow is fresh.scalers[1].overflow
    handle = amp.init()
    assert handle.is_active() and not amp.init(enabled=False).is_active()
    with handle.scale_loss(torch.tensor(2.0), topt, state=loaded) as s:
        assert s.item() == 2.0 * 65536.0
