"""Port parity of the fused LM head: ``apex_tpu_torch.ops.xent`` against
``apex_tpu/ops/xent_pallas.py`` (its Pallas kernels in interpret mode, as
``tests/test_xent_pallas.py`` runs them on the CPU), and the port's
``GPTModel(fused_lm_head=True)`` against the JAX one on one tree and
against its own materialized head.

JAX runs with ``APEX_DISPATCH=off`` and the fused head's
``fused_lm_head_interpret=True`` test knob; the GPT configuration has
h = 128 and V = 768, since the JAX fused branch needs h % 128 == 0.

Tolerances, from what these cases measure on the CPU:
- the plain versions against the Pallas kernels: fp32 loss within 1e-6
  relative (measured at most 2.3e-7) and dX, dE within 1e-5 of each
  tensor's largest magnitude (measured at most 6.4e-7); bf16 loss within
  1e-6 relative (measured 1.8e-7: the logits are fp32 on both sides) and
  dX, dE within 5e-4 relative L2 (measured at most 1.6e-4: both sides
  round coeff and dl * x to bf16 at the same points, and an fp32 sum in
  another order flips a few of those roundings);
- the fused GPT model against the JAX one, and the trajectory: as
  ``test_torch_training.py`` holds the materialized head (1e-4 of the
  largest magnitude; losses within 1e-5 relative);
- the port's fused head against its materialized head: the same fp32
  math summed in another order, 1e-5 of the largest magnitude (measured
  4.9e-7); in bf16 the materialized head rounds the logits and their
  gradient to bf16 and the fused head does not, so the per-token loss
  agrees within 5e-3 (measured 1.5e-3) and each gradient within 1e-2
  relative L2 (measured at most 4.8e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_training as training
from apex_tpu.ops import xent_pallas
from apex_tpu.serving import model as jserving
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu_torch.ops import xent
from apex_tpu_torch.transformer.testing import GPTModel
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig
from apex_tpu_torch.transformer.testing import standalone_transformer_lm

FKW = dict(training.KW, hidden_size=128, vocab_size=768,
           fused_lm_head=True)
B, S = training.B, training.S


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")
    monkeypatch.delenv("APEX_XENT_ROW_BLOCK", raising=False)


@pytest.fixture(scope="module")
def fused_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        return jax.tree_util.tree_map(
            np.asarray,
            jserving.init_gpt_params(training._jax_config(FKW)))


def _case(n, V, h, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, h) * 0.3).astype(np.float32)
    e = (rs.randn(V, h) * 0.3).astype(np.float32)
    labels = rs.randint(0, V, (n,)).astype(np.int32)
    g = (rs.rand(n) + 0.5).astype(np.float32)   # non-uniform cotangent
    return x, e, labels, g


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 768, 128), (1024, 1280, 128)],
                         ids=["two_vocab_chunks", "nb2_nv5"])
def test_plain_versions_match_xent_pallas(shape, dtype, smoothing):
    n, V, h = shape
    x, e, labels, g = _case(n, V, h, seed=1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert xent.supported(n, V, h)

    def f(xx, ee):
        return xent_pallas.linear_cross_entropy(
            xx, ee, jnp.asarray(labels), True, smoothing)

    loss_j, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(e, jdt))
    dx_j, de_j = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(g)))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    te = torch.from_numpy(e).to(tdt).requires_grad_()
    loss = xent.linear_cross_entropy(tx, te, torch.from_numpy(labels),
                                     smoothing)
    loss.backward(torch.from_numpy(g))
    assert loss.dtype == torch.float32 and loss.shape == (n,)
    assert tx.grad.dtype == te.grad.dtype == tdt
    loss_j = np.asarray(loss_j)
    np.testing.assert_allclose(loss.detach().numpy(), loss_j, rtol=1e-6)
    for got, want in ((tx.grad, dx_j), (te.grad, de_j)):
        got = got.float().numpy()
        if dtype == "float32":
            training._close_scaled(got, want, 1e-5)
        else:
            assert _rel_l2(got, want) <= 5e-4


def test_supported_matches_xent_pallas():
    shapes = [(8192, 50304, 768), (8192, 30592, 1024), (8192, 50000, 768),
              (7, 50304, 768), (8192, 50304, 760), (64, 768, 128),
              (1024, 1280, 128), (128, 384, 128)]
    shapes += [(n, V, h) for n in (8, 12, 16, 24, 200, 1032, 4096)
               for V in (128, 384, 640, 1000, 1280, 50304)
               for h in (64, 128, 768, 1024, 4096, 10880, 12288)]
    got = [xent.supported(*s) for s in shapes]
    assert got == [xent_pallas.supported(*s) for s in shapes]
    assert any(got) and not all(got)


def test_k7_form_and_grid_follow_dtype_and_shape(monkeypatch):
    """K7's tensor-core body takes bf16/fp16 at h % 64 == 0, the other
    forms the rest; its grid is whole waves of one block an SM (on 132
    SMs: 64 row blocks x 33 shares of the 197 or 99 256-wide tiles of the
    training shapes), the other forms' two blocks an SM."""
    from apex_tpu_torch.ops import xent_cuda

    assert xent_cuda.fwd_tc_takes(torch.bfloat16, 768)
    assert xent_cuda.fwd_tc_takes(torch.float16, 128)
    assert not xent_cuda.fwd_tc_takes(torch.bfloat16, 160)
    assert not xent_cuda.fwd_tc_takes(torch.float32, 768)
    monkeypatch.setattr(xent_cuda, "_sm_count", lambda index: 132)
    card = torch.device("cuda", 0)
    for V in (50304, 25216):
        assert xent_cuda._vocab_splits(8192, V, 768, torch.bfloat16,
                                       card) == 33
    assert xent_cuda._vocab_splits(200, 384, 128, torch.float16, card) == 2
    assert xent_cuda._vocab_splits(8192, 50304, 768, torch.float32,
                                   card) == 4
    assert xent_cuda._vocab_splits(8192, 50304, 160, torch.bfloat16,
                                   card) == 4


def test_linear_cross_entropy_refuses_other_devices():
    x = torch.zeros(8, 128, device="meta")
    with pytest.raises(ValueError, match="device"):
        xent.linear_cross_entropy(x, torch.zeros(128, 128, device="meta"),
                                  torch.zeros(8, dtype=torch.long,
                                              device="meta"))


def test_fused_gpt_model_matches_jax_fp32(fused_tree, monkeypatch):
    ids, pos, labels = training._batch(kw=FKW)
    jm = JGPT(training._jax_config(FKW))
    per_tok_j = training._shmap(lambda p, i, q, lab: jm.apply(
        {"params": p}, i, q, None, lab), 4)(fused_tree, ids, pos, labels)
    loss_j, grads_j = training._shmap(lambda p, i, q, lab: jax.value_and_grad(
        lambda p_: jnp.mean(jm.apply({"params": p_}, i, q, None, lab)))(p),
        4)(fused_tree, ids, pos, labels)

    def refuse(*_a, **_k):
        raise AssertionError("the fused model ran the materialized head")

    monkeypatch.setattr(standalone_transformer_lm,
                        "vocab_parallel_cross_entropy", refuse)
    model = training._torch_model(fused_tree, kw=FKW)
    tids, tpos, tlabels = training._tt(ids, pos, labels)
    per_tok = model(tids, tpos, None, tlabels)
    assert per_tok.shape == (B, S) and per_tok.dtype == torch.float32
    loss = per_tok.mean()
    loss.backward()
    training._close_scaled(per_tok, per_tok_j, 1e-4, "per_tok")
    training._close_scaled(loss, loss_j, 1e-5, "loss")
    flat = training._flat_jax(grads_j)
    for name, p in model.named_parameters():
        training._close_scaled(p.grad, flat[name], 1e-4, name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_and_materialized_heads_agree(fused_tree, bf16):
    ids, pos, labels = training._tt(*training._batch(kw=FKW))
    out = []
    for fused in (True, False):
        kw = dict(FKW, fused_lm_head=fused)
        model = training._torch_model(fused_tree, bf16, kw)
        per_tok = model(ids, pos, None, labels)
        per_tok.mean().backward()
        out.append((per_tok.detach(), {n: p.grad.float().numpy()
                                       for n, p in model.named_parameters()}))
    (fused_tok, fused_grads), (mat_tok, mat_grads) = out
    if bf16:
        assert (fused_tok - mat_tok).abs().max().item() <= 5e-3
        for name, g in fused_grads.items():
            assert _rel_l2(g, mat_grads[name]) <= 1e-2, name
    else:
        training._close_scaled(fused_tok, mat_tok.numpy(), 1e-5)
        for name, g in fused_grads.items():
            training._close_scaled(g, mat_grads[name], 1e-5, name)


def test_fused_head_trajectory_matches_jax_bench_step(fused_tree):
    steps, forced = 8, 3
    losses, (_, jopt, jss), (_, topt, tss) = training._run_trajectory(
        fused_tree, False, steps, forced, kw=FKW)
    for i, (jl, tl) in enumerate(losses):
        if i == forced:        # inf / inf: the unscaled loss is NaN
            assert np.isnan(jl) and np.isnan(tl)
        else:
            assert abs(jl - tl) <= 1e-5 * abs(jl), (i, jl, tl)
    finite = [jl for i, (jl, _) in enumerate(losses) if i != forced]
    assert finite[-1] < finite[0]
    training._scaler_states_equal(jss, tss)
    assert int(jopt.count) == topt.count.item() == steps - 1


def test_gpt_model_takes_the_materialized_head_where_unsupported():
    # h = 64 is not a multiple of 128: the fused branch does not apply
    calls = []
    model = GPTModel(TConfig(**dict(training.KW, fused_lm_head=True)),
                     device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xent, "linear_cross_entropy",
                   lambda *a: calls.append(a))
        loss = model(ids, torch.arange(8)[None], None, ids)
    assert calls == [] and loss.shape == (1, 8)
