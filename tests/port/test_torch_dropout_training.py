"""Port parity of training with dropout: hidden dropout
(``apex_tpu_torch.utils``), the model's dropout route and per-layer
attention seeds, recompute, and ``make_one_step(...,
dropout_generator=...)``, against the JAX package's ``GPTModel`` and a
JAX step written after ``benchmarks/profile_gpt.py:181-207`` on one
weight tree (the JAX init, carried by ``from_jax_params``).

The two packages draw from different generators, so both are handed the
same draws. On the JAX side, ``derive_attention_dropout_seed`` returns
the next seed of a list and flax's ``nn.Dropout`` takes the next mask of
a list (its ``random.bernoulli`` is replaced, so its own ``lax.select(mask,
x / keep_prob, 0)`` runs); both lists are arguments of the jitted
function. On the port's side, ``derive_attention_dropout_seed`` and
``utils.keep_mask`` still draw from the generator, and each new draw picks
the next seed or mask of the same lists: a recomputed layer that replays
its generator state gets the masks of its first forward, and one that
did not would get the next ones, and fail.

S = 128: the JAX model takes its in-kernel dropout route only where
``attention_pallas.supported(s, s, hd, dropout=True)`` holds (s a
multiple of 128); below it falls back to ``nn.Dropout`` on materialized
probabilities. Each test asserts that the route ran (the rows kernel,
in interpret mode, was called once per layer). Tolerances as
``test_torch_training.py`` holds the model without dropout: per-token loss
and every gradient within 1e-4 of each tensor's largest magnitude, the
trajectory's losses within 1e-5 relative. Recompute on the port gives
the loss and gradients of no recompute bit for bit.
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
from apex_tpu.optimizers.fused_adam import fused_adam as jfused_adam
from apex_tpu.serving import model as jserving
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu.transformer.testing import standalone_transformer_lm as jlm
from apex_tpu_torch import utils as tutils
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train_step import make_one_step
from apex_tpu_torch.transformer.testing import GPTModel
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig
from apex_tpu_torch.transformer.testing import standalone_transformer_lm as tlm

torch.set_num_threads(2)

KW = dict(training.KW, max_position_embeddings=128, hidden_dropout=0.1,
          attention_dropout=0.1)
B, S, H, L = 2, 128, KW["hidden_size"], KW["num_layers"]
N_MASKS = 1 + 2 * L     # the embedding's, then two per layer


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
    """``steps`` sets of (L seeds, N_MASKS keep masks [S, B, H])."""
    rs = np.random.RandomState(100 + seed)
    seeds = rs.randint(-2 ** 31, 2 ** 31 - 1, (steps, L)).astype(np.int32)
    seeds[0, 0] = -2 ** 31                       # an extreme seed too
    masks = rs.rand(steps, N_MASKS, S, B, H) >= KW["hidden_dropout"]
    return seeds, masks


class _JaxDraws:
    """Replaces the JAX model's seed and mask draws with the arrays
    ``load``ed inside the traced function, in call order, and counts the
    rows kernel's calls."""

    def __init__(self, monkeypatch):
        self.rows_calls = 0
        rows = ap.fused_attention_rows

        def counted_rows(*args, **kwargs):
            self.rows_calls += 1
            return rows(*args, **kwargs)

        monkeypatch.setattr(jlm, "derive_attention_dropout_seed", self.seed)
        monkeypatch.setattr(flax_stochastic, "random",
                            types.SimpleNamespace(bernoulli=self.bernoulli))
        monkeypatch.setattr(ap, "fused_attention_rows", counted_rows)

    def load(self, seeds, masks):
        self.seeds, self.masks = seeds, masks
        self.n_seeds = self.n_masks = self.rows_calls = 0

    def seed(self, key, axis_name):
        assert self.n_seeds < self.seeds.shape[0]
        self.n_seeds += 1
        return self.seeds[self.n_seeds - 1].reshape(1, 1)

    def bernoulli(self, key, p, shape):
        assert self.n_masks < self.masks.shape[0]
        assert tuple(shape) == tuple(self.masks.shape[1:])
        assert abs(p - (1.0 - KW["hidden_dropout"])) < 1e-12
        self.n_masks += 1
        return self.masks[self.n_masks - 1]

    def check_route(self):
        assert (self.n_seeds, self.n_masks) == (L, N_MASKS)
        assert self.rows_calls == L, "the in-kernel dropout route did not run"


class _TorchDraws:
    """Each new generator draw of the port's seed or mask picks the next
    entry of the same lists the JAX side takes."""

    def __init__(self, monkeypatch, seeds, masks):
        self.seeds = seeds.reshape(-1)
        self.masks = masks.reshape(-1, S, B, H)
        self.seed_keys, self.mask_keys = {}, {}
        derive = tlm.derive_attention_dropout_seed

        def seed(generator, rank=0):
            key = int(derive(generator, rank))
            i = self.seed_keys.setdefault(key, len(self.seed_keys))
            return torch.tensor([self.seeds[i]], dtype=torch.int32)

        def keep_mask(generator, shape, p, device):
            assert p == KW["hidden_dropout"]
            key = int(torch.randint(0, 2 ** 62, (), generator=generator))
            i = self.mask_keys.setdefault(key, len(self.mask_keys))
            mask = torch.from_numpy(self.masks[i])
            assert mask.shape == tuple(shape)
            return mask

        monkeypatch.setattr(tlm, "derive_attention_dropout_seed", seed)
        monkeypatch.setattr(tutils, "keep_mask", keep_mask)


def _jax_loss_and_grads(tree, granularity, seeds, masks, monkeypatch):
    draws = _JaxDraws(monkeypatch)
    jm = JGPT(training._jax_config(dict(KW,
                                        recompute_granularity=granularity)))

    def f(p, i, q, lab, sd, mk):
        draws.load(sd, mk)

        def loss_fn(pp):
            per_tok = jm.apply({"params": pp}, i, q, None, lab,
                               deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.mean(per_tok), per_tok

        (_, per_tok), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return per_tok, grads

    out = training._shmap(f, 6)(tree, *_batch(), seeds, masks)
    draws.check_route()
    return out


def _torch_loss_and_grads(tree, granularity, generator):
    model = training._torch_model(tree, kw=dict(
        KW, recompute_granularity=granularity))
    ids, pos, labels = training._tt(*_batch())
    per_tok = model(ids, pos, None, labels, deterministic=False,
                    dropout_generator=generator)
    per_tok.mean().backward()
    return per_tok.detach(), {n: p.grad for n, p in model.named_parameters()}


def _check_against_jax(got, want):
    per_tok, grads = got
    per_tok_j, grads_j = want
    training._close_scaled(per_tok, per_tok_j, 1e-4, "per_tok")
    flat = training._flat_jax(grads_j)
    assert set(flat) == set(grads)
    for name, g in grads.items():
        training._close_scaled(g, flat[name], 1e-4, name)


def test_model_with_dropout_matches_jax_fp32(jax_tree, monkeypatch):
    seeds, masks = _draws(0)
    want = _jax_loss_and_grads(jax_tree, "none", seeds[0], masks[0],
                               monkeypatch)
    _TorchDraws(monkeypatch, seeds, masks)
    got = _torch_loss_and_grads(jax_tree, "none",
                                torch.Generator().manual_seed(1))
    _check_against_jax(got, want)
    # dropout changed the function: the deterministic loss differs
    model = training._torch_model(jax_tree, kw=KW)
    ids, pos, labels = training._tt(*_batch())
    with torch.no_grad():
        assert not torch.allclose(model(ids, pos, None, labels), got[0])


@pytest.mark.parametrize("granularity", ["selective", "full"])
def test_recompute_replays_the_masks(jax_tree, granularity, monkeypatch):
    """The port's recompute gives bit for bit the loss and gradients of no
    recompute with the same generator seed, and JAX's recompute within
    1e-4 on the same draws."""
    ref = _torch_loss_and_grads(jax_tree, "none",
                                torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    got = _torch_loss_and_grads(jax_tree, granularity, gen)
    assert torch.equal(got[0], ref[0])
    for name, g in got[1].items():
        assert torch.equal(g, ref[1][name]), name
    # the recompute put the generator back where the forward left it
    after = torch.Generator().manual_seed(3)
    _torch_loss_and_grads(jax_tree, "none", after)
    assert torch.equal(gen.get_state(), after.get_state())

    seeds, masks = _draws(1)
    want = _jax_loss_and_grads(jax_tree, granularity, seeds[0], masks[0],
                               monkeypatch)
    draws = _TorchDraws(monkeypatch, seeds, masks)
    got = _torch_loss_and_grads(jax_tree, granularity,
                                torch.Generator().manual_seed(4))
    assert (len(draws.seed_keys), len(draws.mask_keys)) == (L, N_MASKS)
    _check_against_jax(got, want)


def test_recompute_without_the_replay_would_be_caught(jax_tree, monkeypatch):
    """Guard of the test above: with the generator not restored, the
    recomputed layers draw new masks and the gradients move."""
    ref = _torch_loss_and_grads(jax_tree, "none",
                                torch.Generator().manual_seed(3))
    monkeypatch.setattr(tlm, "_generator_at",
                        lambda generator, state: tlm.contextlib.nullcontext())
    got = _torch_loss_and_grads(jax_tree, "full",
                                torch.Generator().manual_seed(3))
    assert torch.equal(got[0], ref[0])          # the forward is the same
    assert any(not torch.equal(g, ref[1][n]) for n, g in got[1].items())


def test_train_step_trajectory_with_dropout_matches_jax(jax_tree,
                                                        monkeypatch):
    steps, lr = 4, 1e-3
    seeds, masks = _draws(2, steps)
    draws = _JaxDraws(monkeypatch)
    jm = JGPT(training._jax_config(KW))
    js, jtx = JScaler(), jfused_adam(learning_rate=lr)

    def jstep(p, o, ss, ids, pos, labels, sd, mk):
        # profile_gpt.py:181-207's step body, its rng replaced by draws
        draws.load(sd, mk)

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
    gen = torch.Generator().manual_seed(5)
    tstep = make_one_step(model, ts, ttx, dropout_generator=gen)
    topt, tss = ttx.init(dict(model.named_parameters())), ts.init("cpu")
    _TorchDraws(monkeypatch, seeds, masks)
    tids, tpos, tlabels = training._tt(ids, pos, labels)

    losses = []
    for t in range(steps):
        jparams, jopt, jss, jloss = jstep(jparams, jopt, jss, ids, pos,
                                          labels, seeds[t], masks[t])
        draws.check_route()
        topt, tss, tloss = tstep(topt, tss, tids, tpos, tlabels)
        losses.append((float(jloss), tloss.item()))
    for jl, tl in losses:
        assert abs(jl - tl) <= 1e-5 * abs(jl), losses
    assert losses[-1][1] < losses[0][1]
    assert topt.count.item() == steps


def test_step_with_dropout_never_reads_a_device_value(jax_tree, monkeypatch):
    model = training._torch_model(jax_tree, bf16=True, kw=KW)
    ts, ttx = LossScaler(), fused_adam(1e-3)
    step = make_one_step(model, ts, ttx,
                         dropout_generator=torch.Generator().manual_seed(0))
    opt, ss = ttx.init(dict(model.named_parameters())), ts.init("cpu")
    tids, tpos, tlabels = training._tt(*_batch())

    def refuse(*_a, **_k):
        raise AssertionError("the step read a tensor's value on the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    opt, ss, loss = step(opt, ss, tids, tpos, tlabels)
    monkeypatch.undo()
    assert torch.isfinite(loss).item() and opt.count.item() == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_dropout_survivors_rate_and_replay(dtype):
    p = 0.1
    tdt = getattr(torch, dtype)
    rs = np.random.RandomState(6)
    x = rs.randn(64, 96).astype(np.float32)
    tx = torch.from_numpy(x).to(tdt)
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    y = tutils.train_dropout(gen, tx, p)
    assert y.dtype == tdt
    gen.set_state(state)
    keep = tutils.keep_mask(gen, tx.shape, p, tx.device)
    # the same generator state, the same mask
    assert torch.equal(y != 0, keep & (tx != 0))
    # survivors: x / (1 - p) as JAX's train_dropout computes it (in x's
    # dtype), zeros elsewhere
    want = np.asarray(jnp.asarray(x, getattr(jnp, dtype)) / (1.0 - p),
                      np.float32)
    got = y.float().numpy()
    k = keep.numpy()
    assert np.array_equal(got[k], want[k]) and (got[~k] == 0).all()
    # the kept fraction within a 5-sigma binomial band
    big = tutils.keep_mask(torch.Generator().manual_seed(8), (1 << 20,), p,
                           "cpu")
    n = big.numel()
    assert abs(int(big.sum()) - (1 - p) * n) <= 5 * (n * p * (1 - p)) ** 0.5


def test_bias_dropout_add():
    rs = np.random.RandomState(9)
    x, bias, res = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                    for s in ((16, 8), (8,), (16, 8)))
    assert torch.equal(tutils.bias_dropout_add(x, bias, res, 0.1, False),
                       res + (x + bias))
    gen = torch.Generator().manual_seed(10)
    state = gen.get_state()
    out = tutils.get_bias_dropout_add(True)(x, bias, res, 0.1, gen)
    gen.set_state(state)
    assert torch.equal(out, res + tutils.train_dropout(gen, x + bias, 0.1))
    with pytest.raises(ValueError, match="generator"):
        tutils.bias_dropout_add(x, bias, res, 0.1, True)
    assert torch.equal(tutils.bias_dropout_add(x, bias, res, 0.0, True),
                       res + (x + bias))


def test_attention_seed_draw():
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    a = tlm.derive_attention_dropout_seed(gen)
    assert a.dtype == torch.int32 and a.shape == (1,)
    gen.set_state(state)
    assert torch.equal(tlm.derive_attention_dropout_seed(gen), a)
    draws = torch.cat([tlm.derive_attention_dropout_seed(gen)
                       for _ in range(200)]).long()
    assert draws.min() < -2 ** 29 and draws.max() > 2 ** 29
    # another tensor-parallel rank mixes its rank into the same draw (the
    # rank-0 draw above is unchanged); test_torch_tensor_parallel.py holds
    # four ranks distinct
    gen.set_state(state)
    b = tlm.derive_attention_dropout_seed(gen, rank=1)
    assert b.dtype == torch.int32 and b.shape == (1,)
    assert not torch.equal(a, b)


def test_model_refuses_dropout_it_cannot_draw_or_route(jax_tree):
    ids, pos, labels = training._tt(*_batch())
    model = training._torch_model(jax_tree, kw=KW)
    with pytest.raises(ValueError, match="dropout_generator"):
        model(ids, pos, None, labels, deterministic=False)
    # fused_attention_dropout=False routes to the scores path (its parity
    # is in test_torch_scores_path_training.py); so does an explicit mask,
    # with the same draws: an all-False mask changes nothing there
    scores = GPTModel(TConfig(**dict(KW, fused_attention_dropout=False)),
                      device="cpu")
    loss = scores(ids, pos, None, labels, deterministic=False,
                  dropout_generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss).all()
    masked = scores(ids, pos, torch.zeros(B, 1, S, S, dtype=torch.bool),
                    labels, deterministic=False,
                    dropout_generator=torch.Generator().manual_seed(0))
    assert torch.equal(masked, loss)
    # the in-kernel route's model takes the scores path with a mask, as
    # JAX's does; its draws differ from the in-kernel route's
    with torch.no_grad():
        routed = model(ids, pos, torch.zeros(B, 1, S, S, dtype=torch.bool),
                       labels, deterministic=False,
                       dropout_generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(routed).all()
    # deterministic: no dropout, no generator needed, none drawn
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with torch.no_grad():
        model(ids, pos, None, labels, dropout_generator=gen)
    assert torch.equal(gen.get_state(), state)
