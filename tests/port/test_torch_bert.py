"""Port parity of BERT and the explicit-mask attention routes:
``apex_tpu_torch``'s ``BertModel``, ``TransformerLanguageModel``, the
BERT helpers, ``GPTModel`` with an explicit mask, the BERT tree's
converter and ``make_one_step`` over a ``BertModel`` with ``fused_lamb``,
against the JAX package's on one set of weights (a JAX ``init`` carried
across by ``from_jax_params(..., model="bert")``) and the same numpy
inputs.

The model is tiny: 2 layers, hidden 64, 4 heads, vocab 512, b = 2, s =
128 (and 200). The JAX side runs with ``APEX_DISPATCH=off``,
``fused_lm_head=False`` and, unless a case sets it, no recompute; fp32,
so the scores path's softmax takes the unfused fallback on both sides
(the kernel predicate wants a half dtype), which fills masked scores with
-10000: a fully masked pad row is uniform, not zero, in both packages.

Masks: all ones, or padded at the tail, row 0 with ``S - 51`` valid
tokens and row 1 with one. With dropout both packages are handed the same
draws (the harness of ``test_torch_dropout_training.py``, keyed by
shape): the attention seeds, the hidden masks ``[S, B, H]`` and, on the
scores path, the probability masks ``[B, heads, S, S]``. At s = 128 the
padded batch trains on the in-kernel segment-id route in both packages
(JAX's rows kernel in interpret mode, counted once per layer; the port's
``fused_attention`` with segment ids, counted); at s = 200 (not a
multiple of 128) both take the scores path with the extended mask.

Tolerances: per-token loss, binary logits and every gradient within 1e-4
of each tensor's largest magnitude (as ``test_torch_training.py``);
parameters outside the loss have a zero gradient on both sides, exactly.
The 7-step LAMB trajectory: losses within 1e-5 relative; the pooler, the
binary head and the tokentype table, which move by LAMB's weight decay
alone, within 1e-6 of their largest magnitude, their moments exactly 0;
the forced overflow (an infinite loss scale) skipped bitwise on both
sides. The converter's round trip is bit-exact.
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
from apex_tpu.amp.scaler import LossScalerState as JScalerState
from apex_tpu.ops import attention_pallas as ap
from apex_tpu.optimizers.fused_lamb import fused_lamb as jfused_lamb
from apex_tpu.transformer.testing import BertModel as JBert
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu.transformer.testing import TransformerLanguageModel as JTLM
from apex_tpu.transformer.testing import standalone_transformer_lm as jlm
from apex_tpu_torch import utils as tutils
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.optimizers import fused_lamb
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.train_step import make_one_step
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.enums import AttnType, LayerType
from apex_tpu_torch.transformer.testing import (BertModel, GPTModel,
                                                ParallelAttention,
                                                ParallelTransformerLayer,
                                                bert_model_provider,
                                                get_language_model)
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig
from apex_tpu_torch.transformer.testing import standalone_transformer_lm as tlm

torch.set_num_threads(2)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=512, max_position_embeddings=256, hidden_dropout=0.0,
          attention_dropout=0.0, fused_lm_head=False,
          recompute_granularity="none")
DROP = dict(KW, hidden_dropout=0.1, attention_dropout=0.1)
B, H, L, NP = 2, KW["hidden_size"], KW["num_layers"], KW["num_attention_heads"]
# parameters the MLM loss does not reach when no tokentype ids are given
OUTSIDE_LOSS = ("embedding.tokentype_embeddings", "pooler.dense.kernel",
                "pooler.dense.bias", "binary_head.kernel",
                "binary_head.bias")


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")


def _batch(s, padded, seed=0):
    """ids, the ``[B, s]`` attention mask, labels and tokentype ids."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, KW["vocab_size"], (B, s)).astype(np.int32)
    labels = rs.randint(0, KW["vocab_size"], (B, s)).astype(np.int32)
    types_ = rs.randint(0, 2, (B, s)).astype(np.int32)
    mask = np.ones((B, s), np.int32)
    if padded:
        for row, valid in enumerate((s - 51, 1)):
            mask[row, valid:] = 0
            ids[row, valid:] = 0
    return ids, mask, labels, types_


@pytest.fixture(scope="module")
def jax_tree():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        ids, mask, _, _ = _batch(128, False)
        jm = JBert(training._jax_config(KW))
        tree = training._shmap(lambda i, m: jm.init(
            jax.random.PRNGKey(0), i, m)["params"], 2)(ids, mask)
        return jax.tree_util.tree_map(np.asarray, tree)


def _torch_bert(tree, kw=KW):
    cfg = TConfig(**kw)
    model = BertModel(cfg, device="cpu", seed=3)
    tweights.load_param_tree(model, tweights.from_jax_params(
        tree, cfg, "cpu", model="bert"))
    return model


def _port_grads(model):
    """The model's gradients as the JAX tree's flat leaves (zeros where a
    parameter has none, flax Dense weights back as kernels)."""
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.zeros_like(p) if p.grad is None else p.grad
    return training._flat_jax(tweights.to_numpy_tree(tree))


class _JaxDraws:
    """The JAX model's attention seeds and flax ``nn.Dropout`` masks come
    from lists loaded inside the traced function, the masks by shape;
    counts the rows kernel's calls."""

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

    def load(self, seeds, hidden, probs):
        self.seeds = seeds
        self.lists = {hidden.shape[1:]: hidden, probs.shape[1:]: probs}
        self.used = dict.fromkeys(self.lists, 0)
        self.n_seeds = self.rows_calls = 0

    def seed(self, key, axis_name):
        self.n_seeds += 1
        return self.seeds[self.n_seeds - 1].reshape(1, 1)

    def bernoulli(self, key, p, shape):
        assert abs(p - 0.9) < 1e-12
        shape = tuple(shape)
        self.used[shape] += 1
        return self.lists[shape][self.used[shape] - 1]


class _TorchDraws:
    """Each new generator draw of the port's attention seed or keep mask
    picks the next entry, for its shape, of the lists the JAX side takes
    (a recompute that replays its generator state gets the same entry);
    counts the in-kernel segment-id route's calls."""

    def __init__(self, monkeypatch, seeds, hidden, probs):
        self.seeds = seeds.reshape(-1)
        # every step's draws in one list per shape
        self.lists = {t.shape[2:]: t.reshape(-1, *t.shape[2:])
                      for t in (hidden, probs)}
        self.seed_keys = {}
        self.mask_keys = {shape: {} for shape in self.lists}
        self.segment_calls = 0
        derive, attention = (tlm.derive_attention_dropout_seed,
                             tlm.fused_attention)

        def seed(generator, rank=0):
            key = int(derive(generator, rank))
            i = self.seed_keys.setdefault(key, len(self.seed_keys))
            return torch.tensor([self.seeds[i]], dtype=torch.int32)

        def keep_mask(generator, shape, p, device):
            assert p == 0.1
            keys = self.mask_keys[tuple(shape)]
            key = int(torch.randint(0, 2 ** 62, (), generator=generator))
            i = keys.setdefault(key, len(keys))
            return torch.from_numpy(self.lists[tuple(shape)][i])

        def counted(*args, **kwargs):
            if kwargs.get("segment_ids") is not None:
                assert not kwargs["causal"] and kwargs["dropout_p"] > 0
                self.segment_calls += 1
            return attention(*args, **kwargs)

        monkeypatch.setattr(tlm, "derive_attention_dropout_seed", seed)
        monkeypatch.setattr(tutils, "keep_mask", keep_mask)
        monkeypatch.setattr(tlm, "fused_attention", counted)


def _draws(s, steps=1, seed=0):
    rs = np.random.RandomState(300 + seed)
    seeds = rs.randint(-2 ** 31, 2 ** 31 - 1, (steps, L)).astype(np.int32)
    hidden = rs.rand(steps, 1 + 2 * L, s, B, H) >= 0.1
    probs = rs.rand(steps, L, B, NP, s, s) >= 0.1
    return seeds, hidden, probs


def _jax_bert_grads(tree, kw, batch, monkeypatch, draws=None,
                    tokentypes=False):
    jdraws = _JaxDraws(monkeypatch)
    jm = JBert(training._jax_config(kw))
    drop = draws is not None
    seeds, hidden, probs = draws if drop else _draws(8)

    def f(p, ids, mask, labels, tt, sd, hm, pm):
        jdraws.load(sd, hm, pm)

        def loss_fn(pp):
            lm_loss, binary = jm.apply(
                {"params": pp}, ids, mask, tt if tokentypes else None,
                labels, deterministic=not drop,
                rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.mean(lm_loss), (lm_loss, binary)

        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return out, grads

    (lm_loss, binary), grads = training._shmap(f, 8)(
        tree, *batch, seeds[0], hidden[0], probs[0])
    return lm_loss, binary, training._flat_jax(grads), jdraws


def _torch_bert_grads(tree, kw, batch, generator=None, tokentypes=False):
    model = _torch_bert(tree, kw)
    ids, mask, labels, tt = (torch.from_numpy(a) for a in batch)
    drop = {} if generator is None else dict(deterministic=False,
                                             dropout_generator=generator)
    lm_loss, binary = model(ids.long(), mask, tt.long() if tokentypes
                            else None, labels.long(), **drop)
    lm_loss.mean().backward()
    return lm_loss.detach(), binary.detach(), _port_grads(model)


def _check(got, want, zero_grads):
    lm_loss, binary, grads = got
    lm_loss_j, binary_j, grads_j = want
    assert lm_loss.shape == (B, lm_loss_j.shape[1])
    training._close_scaled(lm_loss, lm_loss_j, 1e-4, "lm_loss")
    training._close_scaled(binary, binary_j, 1e-4, "binary_logits")
    assert set(grads) == set(grads_j)
    for name, g in grads.items():
        if name in zero_grads:
            assert not np.asarray(grads_j[name]).any(), name
            assert not g.any(), name
        else:
            training._close_scaled(g, grads_j[name], 1e-4, name)


# (sequence, padded, dropout, recompute, the route under dropout)
CASES = [
    (128, False, False, "none", None),
    (128, True, False, "none", None),
    (128, True, True, "none", "segments"),
    (200, True, True, "none", "scores"),
    (128, True, True, "selective", "segments"),
    (128, True, True, "full", "segments"),
]


@pytest.mark.parametrize("s,padded,dropout,granularity,route", CASES)
def test_bert_loss_and_every_gradient_match_jax(jax_tree, monkeypatch, s,
                                                padded, dropout, granularity,
                                                route):
    kw = dict(DROP if dropout else KW, recompute_granularity=granularity)
    batch = _batch(s, padded)
    # the deterministic padded case passes tokentype ids (the table gets a
    # gradient); every other case leaves them out (its gradient is zero)
    tokentypes = padded and not dropout
    draws = _draws(s) if dropout else None
    lm_j, bin_j, grads_j, jdraws = _jax_bert_grads(
        jax_tree, kw, batch, monkeypatch, draws, tokentypes)
    gen = None
    if dropout:
        tdraws = _TorchDraws(monkeypatch, *draws)
        gen = torch.Generator().manual_seed(5)
    got = _torch_bert_grads(jax_tree, kw, batch, gen, tokentypes)
    zero = [n for n in OUTSIDE_LOSS
            if not (tokentypes and n.startswith("embedding"))]
    _check(got, (lm_j, bin_j, grads_j), zero)
    # the route each side took
    segments = route == "segments"
    assert jdraws.rows_calls == (L if segments else 0)
    if dropout:
        assert jdraws.n_seeds == (L if segments else 0)
        assert jdraws.used == {(s, B, H): 1 + 2 * L,
                               (B, NP, s, s): 0 if segments else L}
        # a recomputed attention runs its route again in the backward
        again = 2 if granularity != "none" else 1
        assert tdraws.segment_calls == (again * L if segments else 0)
        assert len(tdraws.seed_keys) == jdraws.n_seeds
    if granularity != "none":
        # the port's recompute replays its draws: bit for bit no recompute
        ref = _torch_bert_grads(jax_tree, dict(kw, recompute_granularity=
                                               "none"), batch,
                                torch.Generator().manual_seed(5), tokentypes)
        assert torch.equal(got[0], ref[0])
        for name, g in got[2].items():
            assert np.array_equal(g, ref[2][name]), name


def test_bert_helpers_and_the_route_decision_match_jax():
    rs = np.random.RandomState(1)
    mask = (rs.rand(3, 10) > 0.3).astype(np.int32)
    want = np.asarray(jlm.bert_extended_attention_mask(jnp.asarray(mask)))
    got = tlm.bert_extended_attention_mask(torch.from_numpy(mask))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    ids = np.zeros((3, 10), np.int32)
    assert np.array_equal(tlm.bert_position_ids(torch.from_numpy(ids)),
                          np.asarray(jlm.bert_position_ids(ids)))
    # the in-kernel route's shapes, JAX's attention_pallas.supported
    # (dropout=True): 54528 is the longest key row it takes
    for sq in (8, 12, 24, 128, 200, 512):
        for sk in (64, 120, 128, 192, 200, 512, 54528, 54656):
            for hd in (32, 64, 80, 256, 264):
                assert tlm._rows_dropout_supported(sq, sk, hd) == \
                    ap.supported(sq, sk, hd, dropout=True), (sq, sk, hd)
    for change in ({}, dict(fused_attention_dropout=False),
                   dict(attention_dropout=0.0)):
        for deterministic in (True, False):
            for s in (128, 192, 200, 512, 54528, 54656):
                for hd in (64, 256, 320):
                    kw = dict(DROP, **change)
                    assert tlm.fused_padding_dropout_eligible(
                        TConfig(**kw), deterministic, s, hd) == \
                        jlm.fused_padding_dropout_eligible(
                            training._jax_config(kw), deterministic, s, hd)


def test_transformer_language_model_with_the_pooler_matches_jax(monkeypatch):
    kw = dict(KW, recompute_granularity="none")
    ids, mask, _, tt = _batch(128, True, seed=2)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(128, dtype=np.int32)[None], (B, 128)))
    ext = np.array(jlm.bert_extended_attention_mask(jnp.asarray(mask)))
    jm = JTLM(training._jax_config(kw), num_tokentypes=2, add_pooler=True)
    tree = jax.tree_util.tree_map(np.asarray, training._shmap(
        lambda i, q, m, t: jm.init(jax.random.PRNGKey(1), i, q, m, t)[
            "params"], 4)(ids, pos, ext, tt))

    def f(p, i, q, m, t):
        def loss_fn(pp):
            enc, pooled, _ = jm.apply({"params": pp}, i, q, m, t,
                                      pooling_sequence_index=3)
            return jnp.mean(enc ** 2) + jnp.mean(pooled), (enc, pooled)

        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return out, grads

    (enc_j, pooled_j), grads_j = training._shmap(f, 5)(tree, ids, pos, ext,
                                                       tt)
    model, key = get_language_model(TConfig(**kw), num_tokentypes=2,
                                    add_pooler=True, device="cpu")
    assert key == "language_model"
    flat = training._flat_jax(tree)
    tweights.load_param_tree(model, {
        n: flat[n] if n in flat else flat[n[:-len("weight")] + "kernel"].T
        for n, _ in model.named_parameters()})
    enc, pooled, table = model(*(torch.from_numpy(a).long()
                                 for a in (ids, pos)),
                               torch.from_numpy(ext),
                               torch.from_numpy(tt).long(),
                               pooling_sequence_index=3)
    assert table is model.word_embeddings
    (torch.mean(enc ** 2) + torch.mean(pooled)).backward()
    training._close_scaled(enc, enc_j, 1e-4, "encoder_output")
    training._close_scaled(pooled, pooled_j, 1e-4, "pooled")
    flat_g = training._flat_jax(grads_j)
    got = _port_grads(model)
    assert set(got) == set(flat_g)
    for name, g in got.items():
        training._close_scaled(g, flat_g[name], 1e-4, name)


def test_gpt_model_with_an_explicit_mask_matches_jax():
    """The explicit mask takes GPT's causal attention onto the scores path
    in both packages; in fp32 the unfused softmax ORs it with the
    triangle (a fully masked row is uniform)."""
    ids, pos, labels = training._batch()
    rs = np.random.RandomState(7)
    mask = rs.rand(training.B, 1, training.S, training.S) < 0.3
    mask[0, 0, 0, 0] = True                     # a fully masked row
    jm = JGPT(training._jax_config())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        tree = jax.tree_util.tree_map(
            np.asarray, training.jserving.init_gpt_params(
                training.JConfig(**training.KW)))
    loss_j, grads_j = training._shmap(
        lambda p, i, q, m, lab: jax.value_and_grad(lambda p_: jnp.mean(
            jm.apply({"params": p_}, i, q, m, lab)))(p),
        5)(tree, ids, pos, mask, labels)
    model = training._torch_model(tree)
    tids, tpos, tlabels = training._tt(ids, pos, labels)
    loss = model(tids, tpos, torch.from_numpy(mask), tlabels).mean()
    loss.backward()
    training._close_scaled(loss, loss_j, 1e-5, "loss")
    flat = training._flat_jax(grads_j)
    for name, p in model.named_parameters():
        training._close_scaled(p.grad, flat[name], 1e-4, name)
    with torch.no_grad():
        assert not torch.allclose(model(tids, tpos, None, tlabels).mean(),
                                  loss)


def test_bert_tree_converter_round_trip_and_refusals(jax_tree):
    cfg = TConfig(**KW)
    shapes = tweights.param_shapes(cfg, "bert")
    assert shapes["binary_head"]["weight"] == (2, H)
    model = _torch_bert(jax_tree)
    flat = training._flat_jax(jax_tree)
    assert set(model.state_dict()) == {
        n.replace(".kernel", ".weight") for n in flat}
    kernel = np.array(flat["binary_head.kernel"].T)
    assert torch.equal(model.binary_head.weight.detach(),
                       torch.from_numpy(kernel))
    back = training._flat_jax(tweights.to_numpy_tree(
        tweights.param_tree(model)))
    assert set(back) == set(flat)
    for name, a in back.items():
        assert a.dtype == flat[name].dtype and a.shape == flat[name].shape
        assert np.array_equal(a.view(np.uint32), flat[name].view(np.uint32))
    # without the binary head: no pooler, no binary head, binary_logits
    # None
    plain = TConfig(**dict(KW, bert_binary_head=False))
    small = {k: v for k, v in jax_tree.items()
             if k not in ("pooler", "binary_head")}
    nb = BertModel(plain, device="cpu")
    tweights.load_param_tree(nb, tweights.from_jax_params(small, plain, "cpu",
                                                          model="bert"))
    ids, mask, _, _ = _batch(128, True)
    with torch.no_grad():
        logits, binary = nb(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask))
    assert binary is None and logits.shape == (B, 128, KW["vocab_size"])
    # a GPT tree lacks BERT's leaves; a kernel in the port's layout is a
    # shape the config does not imply
    gpt_tree = {"word_embeddings": jax_tree["word_embeddings"],
                "transformer": jax_tree["transformer"],
                "embedding": {"position_embeddings": jax_tree["embedding"][
                    "position_embeddings"]}}
    with pytest.raises(KeyError, match="tokentype"):
        tweights.from_jax_params(gpt_tree, cfg, "cpu", model="bert")
    flipped = dict(jax_tree, binary_head=dict(
        jax_tree["binary_head"], kernel=flat["binary_head.kernel"].T))
    with pytest.raises(ValueError, match="binary_head/kernel"):
        tweights.from_jax_params(flipped, cfg, "cpu", model="bert")
    with pytest.raises(ValueError, match="model"):
        tweights.param_shapes(cfg, "t5")


def test_what_the_bert_slice_does_not_model_raises(monkeypatch):
    cfg = TConfig(**KW)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="cross-attention"):
        ParallelAttention(cfg, "cpu", gen, attention_type=AttnType.cross_attn)
    with pytest.raises(ValueError, match="decoder"):
        ParallelTransformerLayer(cfg, "cpu", gen,
                                 layer_type=LayerType.decoder)
    with pytest.raises(ValueError, match="pipeline"):
        bert_model_provider(cfg, pre_process=False)
    assert isinstance(bert_model_provider(cfg, device="cpu"), BertModel)
    gpt = GPTModel(cfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="tokentype"):
        gpt.embedding(gpt.word_embeddings, ids, ids, ids)
    monkeypatch.setattr(parallel_state,
                        "get_tensor_model_parallel_world_size", lambda: 2)
    with pytest.raises(ValueError, match="tp = 1"):
        BertModel(cfg, device="cpu")


def test_make_one_step_trains_bert_with_fused_lamb_like_jax(jax_tree,
                                                            monkeypatch):
    """Seven steps of ``make_one_step(BertModel, LossScaler(),
    fused_lamb)`` against a JAX step written after
    ``examples/transformer/pretrain.py:151-200``'s BERT branch, on a padded
    batch, the fourth step forced to overflow. The pooler, the binary head
    and the tokentype table get zero gradients and move by LAMB's weight
    decay alone, in both packages."""
    steps, forced, lr = 7, 3, 1e-2
    jtx = jfused_lamb(learning_rate=lr, eps=1e-8)
    ttx = fused_lamb(learning_rate=lr, eps=1e-8)
    jm = JBert(training._jax_config(KW))
    js = JScaler()

    def jstep(p, o, ss, ids, mask, labels):
        def loss_fn(pp):
            per_tok = jm.apply({"params": pp}, ids, mask,
                               lm_labels=labels)[0]
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

    jstep = training._shmap(jstep, 6)
    ids, mask, labels, _ = _batch(128, True, seed=4)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    jopt, jss = jtx.init(jparams), js.init()
    model = _torch_bert(jax_tree)
    ts = LossScaler()
    tstep = make_one_step(model, ts, ttx)
    topt = ttx.init(dict(model.named_parameters()))
    tss = ts.init("cpu")
    tids, tmask, tlabels = (torch.from_numpy(a).long()
                            for a in (ids, mask, labels))
    losses = []
    for i in range(steps):
        if i == forced:
            jss = JScalerState(loss_scale=jnp.float32(np.inf),
                               unskipped=jss.unskipped, overflow=jss.overflow)
            tss = ts.load_state_dict(tss, {"loss_scale": np.inf,
                                           "unskipped": tss.unskipped})
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
        jparams, jopt, jss, jloss = jstep(jparams, jopt, jss, ids, mask,
                                          labels)
        if i == 0:
            # the step reads no device value on the host
            def refuse(*_a, **_k):
                raise AssertionError("the step read a tensor's value on "
                                     "the host")

            with monkeypatch.context() as mp:
                mp.setattr(torch.Tensor, "item", refuse)
                mp.setattr(torch.Tensor, "__bool__", refuse)
                topt, tss, tloss = tstep(topt, tss, tids, tmask, tlabels)
        else:
            topt, tss, tloss = tstep(topt, tss, tids, tmask, tlabels)
        losses.append((float(jloss), tloss.item()))
        if i == forced:
            assert bool(jss.overflow) and tss.overflow.item()
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
            jss = JScalerState(loss_scale=jnp.float32(2.0 ** 16),
                               unskipped=jss.unskipped, overflow=jss.overflow)
            tss = ts.load_state_dict(tss, {"loss_scale": 2.0 ** 16,
                                           "unskipped": tss.unskipped})
    for i, (jl, tl) in enumerate(losses):
        if i == forced:
            assert np.isnan(jl) and np.isnan(tl)
        else:
            assert abs(jl - tl) <= 1e-5 * abs(jl), (i, jl, tl)
    finite = [jl for i, (jl, _) in enumerate(losses) if i != forced]
    assert finite[-1] < finite[0]
    assert int(jopt.count) == topt.count.item() == steps - 1
    got = training._flat_jax(tweights.to_numpy_tree(
        tweights.param_tree(model)))
    want = training._flat_jax(jparams)
    init = training._flat_jax(jax_tree)
    jm_flat, jv_flat = (training._flat_jax(t) for t in (jopt.m, jopt.v))
    for name in OUTSIDE_LOSS:
        torch_name = name.replace(".kernel", ".weight")
        training._close_scaled(got[name], want[name], 1e-6, name)
        assert not topt.m[torch_name].any() and not jm_flat[name].any()
        assert not topt.v[torch_name].any() and not jv_flat[name].any()
        if init[name].any():                      # weight decay moved it
            assert not np.array_equal(got[name], init[name]), name
