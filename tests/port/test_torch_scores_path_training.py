"""Port parity of the scores-path training step: ``GPTModel`` with
``fused_attention_dropout=False`` and hidden and attention dropout 0.1
(the classic Megatron attention: scores ``bmm``, ``FusedScaleMaskSoftmax``,
dropout on the probabilities, context ``bmm``) against the JAX package's
``GPTModel`` on one weight tree (the JAX init, carried by
``from_jax_params``).

Two layers, so query-key layer scaling's ``coeff`` (the layer number)
differs between them; S = 128, where ``softmax_pallas.supported`` holds
(sk % 128 == 0), and b * heads = 8, where the kernel predicate
``is_kernel_available`` holds in bf16. Both packages are handed the same
masks, as ``test_torch_dropout_training.py`` hands them: on the JAX side
flax's ``nn.Dropout`` takes the next mask of a list for its shape (the
hidden masks ``[S, B, H]`` and the probability masks ``[B, heads, S,
S]``); on the port's side each new generator draw of ``utils.keep_mask``
picks the next entry of the same list, so a recompute that replays the
generator gets the masks of its first forward.

* fp32: the softmax predicate is false (fp32 input), both take the
  unfused ``forward_torch_softmax``; per-token loss and every gradient
  within 1e-4 of each tensor's largest magnitude, a 4-step trajectory's
  losses within 1e-5 relative.
* bf16: JAX with ``softmax_use_pallas=True`` and
  ``APEX_PALLAS_INTERPRET=1`` runs its Pallas softmax in interpret mode
  (counted: once per layer, and the rows kernel never), the port its
  kernel's plain versions through the same autograd function (counted);
  loss within ``BF16_LOSS_BAND`` and each gradient within
  ``BF16_GRAD_L2_BAND`` relative L2.
* ``recompute_granularity`` "selective" and "full" give the loss and
  gradients of "none" bit for bit.
"""

import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_training as training
from apex_tpu.amp.scaler import LossScaler as JScaler
from apex_tpu.ops import attention_pallas as ap
from apex_tpu.ops import softmax_pallas as jsp
from apex_tpu.optimizers.fused_adam import fused_adam as jfused_adam
from apex_tpu.serving import model as jserving
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu_torch import utils as tutils
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train_step import make_one_step
from apex_tpu_torch.transformer.testing import GPTModel

torch.set_num_threads(2)

KW = dict(training.KW, max_position_embeddings=128, hidden_dropout=0.1,
          attention_dropout=0.1, fused_attention_dropout=False)
B, S, H, L = 2, 128, KW["hidden_size"], KW["num_layers"]
NP = KW["num_attention_heads"]
HIDDEN, PROBS = (S, B, H), (B, NP, S, S)
# bf16: both sides round at the same places (scores, probabilities,
# dropout, context, layer outputs) but sum in another order, and a
# one-ulp flip of a bf16 intermediate moves a gradient by ~2^-8 of its
# scale; measured here 2.3e-5 (loss) and 1.3e-2 (worst gradient)
BF16_LOSS_BAND = 1e-2
BF16_GRAD_L2_BAND = 5e-2


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")


@pytest.fixture(scope="module")
def jax_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        return jax.tree_util.tree_map(
            np.asarray, jserving.init_gpt_params(training._jax_config(KW)))


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, KW["vocab_size"], (B, S)).astype(np.int32)
    labels = rs.randint(0, KW["vocab_size"], (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return ids, pos, labels


def _draws(seed, steps=1):
    """``steps`` sets of keep masks: 1 + 2L hidden ``[S, B, H]`` (the
    embedding's, then two per layer) and L probability ``[B, heads, S,
    S]`` masks (one per layer)."""
    rs = np.random.RandomState(200 + seed)
    p = KW["hidden_dropout"]
    hidden = rs.rand(steps, 1 + 2 * L, *HIDDEN) >= p
    probs = rs.rand(steps, L, *PROBS) >= KW["attention_dropout"]
    return hidden, probs


class _JaxDraws:
    """flax's ``nn.Dropout`` takes the next mask of its shape's list
    (loaded inside the traced function); counts the JAX softmax kernel's
    and the rows kernel's calls."""

    def __init__(self, monkeypatch):
        self.softmax_calls = self.rows_calls = 0
        rows, kernel = ap.fused_attention_rows, jsp.scaled_masked_softmax

        def counted_rows(*args, **kwargs):
            self.rows_calls += 1
            return rows(*args, **kwargs)

        def counted_softmax(*args, **kwargs):
            self.softmax_calls += 1
            return kernel(*args, **kwargs)

        monkeypatch.setattr(flax_stochastic, "random",
                            types.SimpleNamespace(bernoulli=self.bernoulli))
        monkeypatch.setattr(ap, "fused_attention_rows", counted_rows)
        monkeypatch.setattr(jsp, "scaled_masked_softmax", counted_softmax)

    def load(self, hidden, probs):
        self.lists = {HIDDEN: hidden, PROBS: probs}
        self.used = {HIDDEN: 0, PROBS: 0}
        self.softmax_calls = self.rows_calls = 0

    def bernoulli(self, key, p, shape):
        shape = tuple(shape)
        assert abs(p - 0.9) < 1e-12
        i = self.used[shape]
        self.used[shape] += 1
        return self.lists[shape][i]

    def check_route(self, kernel):
        assert self.used == {HIDDEN: 1 + 2 * L, PROBS: L}, self.used
        assert self.rows_calls == 0, "the in-kernel dropout route ran"
        assert self.softmax_calls == (L if kernel else 0), self.softmax_calls


class _TorchDraws:
    """Each new generator draw of ``utils.keep_mask`` picks the next
    entry, for its shape, of the lists the JAX side takes; counts the
    calls of the port's fused softmax."""

    def __init__(self, monkeypatch, hidden, probs):
        self.lists = {HIDDEN: hidden.reshape(-1, *HIDDEN),
                      PROBS: probs.reshape(-1, *PROBS)}
        self.keys = {HIDDEN: {}, PROBS: {}}
        self.softmax_calls = 0
        kernel = tsm.scaled_masked_softmax

        def keep_mask(generator, shape, p, device):
            assert p == 0.1
            shape = tuple(shape)
            key = int(torch.randint(0, 2 ** 62, (), generator=generator))
            i = self.keys[shape].setdefault(key, len(self.keys[shape]))
            return torch.from_numpy(self.lists[shape][i])

        def counted(*args, **kwargs):
            self.softmax_calls += 1
            return kernel(*args, **kwargs)

        monkeypatch.setattr(tutils, "keep_mask", keep_mask)
        monkeypatch.setattr(tsm, "scaled_masked_softmax", counted)


def _jax_config(bf16, **kw):
    cfg = dict(KW, **kw)
    if bf16:
        cfg["softmax_use_pallas"] = True
    return training._jax_config(cfg, bf16=bf16)


def _jax_loss_and_grads(tree, bf16, hidden, probs, monkeypatch,
                        granularity="none"):
    draws = _JaxDraws(monkeypatch)
    jm = JGPT(_jax_config(bf16, recompute_granularity=granularity))

    def f(p, i, q, lab, hm, pm):
        draws.load(hm, pm)

        def loss_fn(pp):
            per_tok = jm.apply({"params": pp}, i, q, None, lab,
                               deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.mean(per_tok), per_tok

        (_, per_tok), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return per_tok, grads

    out = training._shmap(f, 6)(tree, *_batch(), hidden, probs)
    draws.check_route(kernel=bf16)
    return out


def _torch_loss_and_grads(tree, bf16, generator, granularity="none"):
    kw = dict(KW, recompute_granularity=granularity)
    model = training._torch_model(tree, bf16=bf16, kw=kw)
    ids, pos, labels = training._tt(*_batch())
    per_tok = model(ids, pos, None, labels, deterministic=False,
                    dropout_generator=generator)
    per_tok.mean().backward()
    return per_tok.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_scores_path_matches_jax_fp32(jax_tree, monkeypatch):
    hidden, probs = _draws(0)
    want = _jax_loss_and_grads(jax_tree, False, hidden[0], probs[0],
                               monkeypatch)
    draws = _TorchDraws(monkeypatch, hidden, probs)
    per_tok, grads = _torch_loss_and_grads(jax_tree, False,
                                           torch.Generator().manual_seed(1))
    assert {k: len(v) for k, v in draws.keys.items()} \
        == {HIDDEN: 1 + 2 * L, PROBS: L}
    assert draws.softmax_calls == 0     # fp32: the unfused softmax
    training._close_scaled(per_tok, want[0], 1e-4, "per_tok")
    flat = training._flat_jax(want[1])
    assert set(flat) == set(grads)
    for name, g in grads.items():
        training._close_scaled(g, flat[name], 1e-4, name)
    # the scores path is another function than the deterministic model
    model = training._torch_model(jax_tree, kw=KW)
    ids, pos, labels = training._tt(*_batch())
    with torch.no_grad():
        assert not torch.allclose(model(ids, pos, None, labels), per_tok)


def test_scores_path_bf16_matches_the_jax_softmax_kernel(jax_tree,
                                                         monkeypatch):
    monkeypatch.setenv("APEX_PALLAS_INTERPRET", "1")
    hidden, probs = _draws(1)
    want = _jax_loss_and_grads(jax_tree, True, hidden[0], probs[0],
                               monkeypatch)
    draws = _TorchDraws(monkeypatch, hidden, probs)
    per_tok, grads = _torch_loss_and_grads(jax_tree, True,
                                           torch.Generator().manual_seed(2))
    assert draws.softmax_calls == L, "the port's fused softmax did not run"
    loss, jloss = float(per_tok.float().mean()), float(np.mean(want[0]))
    assert abs(loss - jloss) <= BF16_LOSS_BAND, (loss, jloss)
    flat = training._flat_jax(want[1])
    worst = 0.0
    for name, g in grads.items():
        ref = torch.from_numpy(np.array(flat[name], np.float32))
        err = ((g.float() - ref).norm() / ref.norm().clamp(min=1e-30)).item()
        worst = max(worst, err)
        assert err <= BF16_GRAD_L2_BAND, (name, err)
    print(f"bf16 scores path: |loss diff| {abs(loss - jloss):.2e}, worst "
          f"gradient relative L2 {worst:.2e}")


@pytest.mark.parametrize("granularity", ["selective", "full"])
def test_recompute_is_bit_for_bit_none_on_the_scores_path(jax_tree,
                                                          granularity):
    ref = _torch_loss_and_grads(jax_tree, False,
                                torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    got = _torch_loss_and_grads(jax_tree, False, gen, granularity)
    assert torch.equal(got[0], ref[0])
    for name, g in got[1].items():
        assert torch.equal(g, ref[1][name]), name
    # the recompute put the generator back where the forward left it
    after = torch.Generator().manual_seed(3)
    _torch_loss_and_grads(jax_tree, False, after)
    assert torch.equal(gen.get_state(), after.get_state())


def test_scores_path_trajectory_matches_jax(jax_tree, monkeypatch):
    steps, lr = 4, 1e-3
    hidden, probs = _draws(2, steps)
    draws = _JaxDraws(monkeypatch)
    jm = JGPT(_jax_config(False))
    js, jtx = JScaler(), jfused_adam(learning_rate=lr)

    def jstep(p, o, ss, ids, pos, labels, hm, pm):
        draws.load(hm, pm)

        def loss_fn(pp):
            per_tok = jm.apply({"params": pp}, ids, pos, None, labels,
                               deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(11)})
            return jnp.mean(per_tok) * ss.loss_scale

        loss, grads = jax.value_and_grad(loss_fn)(p)
        grads, found_inf = js.unscale(grads, ss)
        nss = js.update(ss, found_inf)
        updates, no = jtx.update(grads, o, p)
        np_ = jax.tree_util.tree_map(
            lambda a, u: jnp.where(found_inf, a, a + u.astype(a.dtype)),
            p, updates)
        no = jax.tree_util.tree_map(
            lambda new, old: jnp.where(found_inf, old, new), no, o)
        return np_, no, nss, loss / ss.loss_scale

    jstep = training._shmap(jstep, 8)
    ids, pos, labels = _batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    jopt, jss = jtx.init(jparams), js.init()

    model = training._torch_model(jax_tree, kw=KW)
    ts, ttx = LossScaler(), fused_adam(learning_rate=lr)
    tstep = make_one_step(model, ts, ttx,
                          dropout_generator=torch.Generator().manual_seed(5))
    topt, tss = ttx.init(dict(model.named_parameters())), ts.init("cpu")
    _TorchDraws(monkeypatch, hidden, probs)
    tids, tpos, tlabels = training._tt(ids, pos, labels)

    losses = []
    for t in range(steps):
        jparams, jopt, jss, jloss = jstep(jparams, jopt, jss, ids, pos,
                                          labels, hidden[t], probs[t])
        draws.check_route(kernel=False)
        topt, tss, tloss = tstep(topt, tss, tids, tpos, tlabels)
        losses.append((float(jloss), tloss.item()))
    for jl, tl in losses:
        assert abs(jl - tl) <= 1e-5 * abs(jl), losses
    assert losses[-1][1] < losses[0][1]


def test_scores_path_routes_like_jax():
    """The scores path runs only in training with attention dropout and
    ``fused_attention_dropout=False``; deterministic calls and training
    without attention dropout keep the flash branch, and the softmax
    routes through the fused kernel's call only where its predicate
    holds and ``softmax_use_pallas`` is True."""
    from apex_tpu_torch.ops import attention as tattn

    ids, pos, labels = training._tt(*_batch())
    calls = {"softmax": 0, "attention": 0}
    kernel, attention = tsm.scaled_masked_softmax, tattn.fused_attention

    def count(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    from apex_tpu_torch.transformer.testing import (
        standalone_transformer_lm as tlm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsm, "scaled_masked_softmax", count("softmax", kernel))
        mp.setattr(tlm, "fused_attention", count("attention", attention))
        for bf16, use, dropout, want in [
                (True, True, True, (L, 0)), (True, False, True, (0, 0)),
                (False, True, True, (0, 0)), (True, True, False, (0, L))]:
            cfg = dict(KW, softmax_use_pallas=use)
            if not dropout:
                cfg.update(attention_dropout=0.0)
            model = GPTModel(training.TConfig(**cfg, bf16=bf16),
                             device="cpu")
            calls.update(softmax=0, attention=0)
            with torch.no_grad():
                model(ids, pos, None, labels, deterministic=False,
                      dropout_generator=torch.Generator().manual_seed(0))
            assert (calls["softmax"], calls["attention"]) == want, (
                bf16, use, dropout, calls)
        calls.update(softmax=0, attention=0)
        with torch.no_grad():
            model(ids, pos, None, labels)        # deterministic: flash
        assert (calls["softmax"], calls["attention"]) == (0, L)
