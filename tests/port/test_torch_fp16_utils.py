"""Port parity of ``apex_tpu_torch.fp16_utils`` against
``apex_tpu.fp16_utils`` on the CPU: the cases of
``tests/test_fp16_utils.py`` over the port's trees (dicts of tensors keyed
by dotted names, and modules), including an overflowing
``FP16_Optimizer`` step and the ``state_dict`` round trip, and JAX's
norm-path predicate applied to the flax key path each port name stands
for, on ResNet-50's and BERT's trees: the same tensors stay fp32 under
``network_to_half`` / ``convert_network`` in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bert as bert
import test_torch_training as training
from apex_tpu.fp16_utils import network_to_half as jnetwork_to_half
from apex_tpu.fp16_utils.fp16util import _is_norm_path as jis_norm
from apex_tpu.models.resnet import BottleneckBlock as JBottleneck
from apex_tpu.models.resnet import ResNet as JResNet
from apex_tpu.transformer.testing import BertModel as JBert
from apex_tpu_torch.fp16_utils import (DynamicLossScaler, FP16_Optimizer,
                                       FP16Model, LossScaler,
                                       clip_grad_norm, convert_network,
                                       master_params_to_model_params,
                                       model_grads_to_master_grads,
                                       network_to_half, prep_param_lists,
                                       to_python_float, tofp16)
from apex_tpu_torch.models import resnet50
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.transformer.testing import BertModel
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig


def _params():
    return {"dense.kernel": torch.ones(4, 4),
            "dense.bias": torch.zeros(4),
            "batchnorm_0.scale": torch.ones(4),
            "step": torch.tensor(3, dtype=torch.int32)}


def test_network_to_half_keeps_norms_fp32():
    half = network_to_half(_params())
    assert half["dense.kernel"].dtype == torch.float16
    assert half["batchnorm_0.scale"].dtype == torch.float32
    assert half["step"].dtype == torch.int32


def test_tofp16_and_convert_network_bf16():
    assert tofp16(_params())["batchnorm_0.scale"].dtype == torch.float16
    conv = convert_network(_params(), torch.bfloat16)
    assert conv["dense.kernel"].dtype == torch.bfloat16
    assert conv["batchnorm_0.scale"].dtype == torch.float32


def test_prep_param_lists_flat_master_roundtrip():
    model = {"a": torch.full((2, 3), 1.5, dtype=torch.float16),
             "b": torch.full((4,), -2.0, dtype=torch.float16)}
    _, master = prep_param_lists(model, flat_master=True)
    assert master.dtype == torch.float32 and master.shape == (10,)
    back = master_params_to_model_params(model, master, flat_master=True)
    for k in model:
        assert torch.equal(back[k], model[k])
    grads = {k: torch.ones_like(v) for k, v in model.items()}
    mg = model_grads_to_master_grads(grads, flat_master=True)
    assert mg.dtype == torch.float32 and mg.shape == (10,)
    _, masters = prep_param_lists(model)
    assert all(m.dtype == torch.float32 for m in masters.values())


def test_clip_grad_norm():
    grads = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, total = clip_grad_norm(grads, max_norm=1.0)
    np.testing.assert_allclose(float(total), np.sqrt(90 + 160), rtol=1e-6)
    new_total = np.sqrt(sum(float(torch.sum(g ** 2))
                            for g in clipped.values()))
    np.testing.assert_allclose(new_total, 1.0, rtol=1e-4)
    _, inf_norm = clip_grad_norm(grads, 1.0, norm_type=float("inf"))
    assert float(inf_norm) == 4.0


def test_to_python_float():
    assert to_python_float(torch.tensor([2.5, 1.0])) == 2.5
    assert to_python_float(torch.tensor(7)) == 7.0


def test_fp16_model_casts_inputs_and_keeps_norms():
    net = torch.nn.Sequential(torch.nn.Linear(4, 4),
                              torch.nn.BatchNorm1d(4))
    model = FP16Model(net)
    assert net[0].weight.dtype == torch.float16
    assert net[1].weight.dtype == torch.float16   # "1" is no norm path
    fn = FP16Model(lambda p, x: (p["w"].dtype, x.dtype))
    assert fn({"w": torch.ones(2), "bn.w": torch.ones(2)},
              torch.ones(2)) == (torch.float16, torch.float16)
    del model


def test_fp16_optimizer_step_and_overflow(capsys):
    params = {"w": torch.full((4,), 2.0, dtype=torch.float16)}
    opt = FP16_Optimizer(fused_adam(learning_rate=0.1), params,
                         dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 8},
                         verbose=False)

    def lg(p_):
        p = p_["w"].float().requires_grad_()
        loss = torch.sum(p ** 2) * opt.scaler_state.loss_scale
        loss.backward()
        return loss.detach(), {"w": p.grad.half()}

    opt.backward(lg, params)
    opt.step()
    assert not opt.overflow
    assert float(opt.master_params["w"][0]) < 2.0
    np.testing.assert_allclose(params["w"].float().numpy(),
                               opt.master_params["w"].numpy(), atol=1e-2)
    before = opt.master_params["w"].clone()
    scale_before = opt.loss_scale
    opt._grads = {"w": torch.full((4,), float("inf"), dtype=torch.float16)}
    opt.step()
    assert opt.overflow and "OVERFLOW" in capsys.readouterr().out
    assert torch.equal(opt.master_params["w"], before)
    assert opt.loss_scale == scale_before / 2
    # a loss tensor back-propagated into the model parameters
    w = torch.full((4,), 2.0, requires_grad=True)
    opt2 = FP16_Optimizer(fused_adam(learning_rate=0.1), {"w": w},
                          verbose=False)
    loss = opt2.backward(torch.sum(w ** 2))
    assert float(loss) == 16.0
    norm = opt2.clip_master_grads(1.0)
    np.testing.assert_allclose(float(norm), 8.0, rtol=1e-6)
    opt2.step()
    assert float(w[0]) < 2.0


def test_fp16_optimizer_state_dict_roundtrip():
    params = {"w": torch.full((4,), 2.0, dtype=torch.float16)}
    opt = FP16_Optimizer(fused_adam(learning_rate=0.1), params,
                         dynamic_loss_scale=True, verbose=False)
    opt.backward(lambda: (torch.tensor(1.0), {"w": torch.ones(
        4, dtype=torch.float16) * opt.scaler_state.loss_scale}))
    opt.step()
    sd = opt.state_dict()
    other = {"w": torch.full((4,), 2.0, dtype=torch.float16)}
    opt2 = FP16_Optimizer(fused_adam(learning_rate=0.1), other,
                          dynamic_loss_scale=True, verbose=False)
    opt2.load_state_dict(sd)
    assert torch.equal(opt2.master_params["w"], opt.master_params["w"])
    assert torch.equal(other["w"], params["w"])
    assert opt2.loss_scale == opt.loss_scale


def test_legacy_loss_scalers():
    s = DynamicLossScaler(init_scale=4.0, scale_window=2)
    assert s.has_overflow({"a": torch.tensor([1.0, float("nan")])})
    assert not s.has_overflow([torch.ones(2)])
    s.update_scale(True)
    assert s.loss_scale == 2.0
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale == 4.0
    for _ in range(5):
        s.update_scale(True)
    assert s.loss_scale == 1      # the floor
    st = LossScaler(3.0)
    loss, g = st.backward(lambda: (1.0, {"a": torch.ones(2)}))
    assert torch.equal(g["a"], torch.full((2,), 3.0))


def _flat_paths(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _kept_modules(dtypes):
    """The modules (path without its last part) of the fp32 tensors."""
    return {name.rsplit(".", 1)[0] for name, dt in dtypes.items()
            if dt == torch.float32}


def test_norm_predicate_on_resnet50_tree():
    jm = JResNet(stage_sizes=[3, 4, 6, 3], block_cls=JBottleneck,
                 num_classes=10, num_filters=8)
    variables = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)),
                        train=False)
    jhalf = _flat_paths(jnetwork_to_half(variables["params"]))
    want = {p.rsplit("/", 1)[0].replace("/", ".") for p, leaf in
            jhalf.items() if leaf.dtype == jnp.float32}
    model = network_to_half(resnet50(num_classes=10, num_filters=8,
                                     device="cpu"))
    got = _kept_modules({n: p.dtype for n, p in model.named_parameters()})
    assert got == want and got
    assert {p for p in jhalf if jis_norm(
        [jax.tree_util.DictKey(k) for k in p.split("/")])} \
        == {p for p in jhalf if jhalf[p].dtype == jnp.float32}


def test_norm_predicate_on_bert_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        ids = np.zeros((2, 128), np.int32)
        jm = JBert(training._jax_config(bert.KW))
        tree = training._shmap(lambda i, m: jm.init(
            jax.random.PRNGKey(0), i, m)["params"], 2)(ids, ids + 1)
    jhalf = _flat_paths(jnetwork_to_half(tree))
    want = {p.rsplit("/", 1)[0].replace("/", ".") for p, leaf in
            jhalf.items() if leaf.dtype == jnp.float32}
    model = BertModel(TConfig(**bert.KW), device="cpu")
    half = network_to_half(dict(model.named_parameters()))
    got = _kept_modules({n: t.dtype for n, t in half.items()})
    assert got == want and got
