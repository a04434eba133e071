"""Port parity past the attention kernels' head dims: the route
(:func:`apex_tpu_torch.ops.attention.kernel_route`) takes the kernels up
to head dim 256 and the scores route past it, where the JAX package
leaves its rows kernel (``attention_pallas.supported``, d <= 256) for
``_dense_attention`` or, in training with attention dropout, for the
scores path.

* the scores route against JAX's ``_dense_attention`` and its VJP, fp32
  within 1e-5 of each tensor's largest magnitude (the same fp32 math,
  summed in another order), causal and segmented, a fully masked row
  giving 0 on both sides;
* a 2-layer ``GPTModel`` at head dim 320 (hidden 1280, 4 heads) and at
  264 (``kv_channels=264``) against the JAX model on one weight tree:
  loss and every gradient in fp32 within 1e-4 of each tensor's largest
  magnitude, without and with attention dropout (both packages handed
  the same hidden ``[S, B, H]`` and probability ``[B, heads, S, S]``
  masks, as ``test_torch_scores_path_training.py`` hands them);
* the serving engine at head dim 320 against the JAX engine, token for
  token in fp32; a head dim past decode's 512 is refused at
  construction.
"""

import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_training as training
from apex_tpu.ops import attention as jattn
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import model as jserving
from apex_tpu.serving import scheduler as jsched
from apex_tpu.transformer.testing import GPTModel as JGPT
from apex_tpu.transformer.testing import TransformerConfig as JConfig
from apex_tpu_torch import utils as tutils
from apex_tpu_torch.ops import attention
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving import weights as tweights
from apex_tpu_torch.transformer.testing import TransformerConfig as TConfig

torch.set_num_threads(2)

# head dim 320 (hidden 1280 over 4 heads) and 264 (kv_channels over 4
# heads of a 64-wide model)
WIDE = {320: dict(training.KW, hidden_size=1280),
        264: dict(training.KW, kv_channels=264)}
B, S = training.B, training.S
P_DROP = 0.1


@pytest.fixture(autouse=True)
def _no_dispatch_table(monkeypatch):
    monkeypatch.setenv("APEX_DISPATCH", "off")


@pytest.mark.parametrize("d", [32, 64, 80, 128, 200, 256, 257, 264, 320,
                               512, 520])
def test_kernel_route_takes_the_kernels_to_256_and_scores_past(d):
    route = attention.kernel_route(d)
    assert route == ("kernels" if d <= 256 else "scores")
    if route == "kernels":
        assert attention._kernel_head_dim(d) >= d
    else:
        with pytest.raises(ValueError, match="head_dim"):
            attention._kernel_head_dim(d)


def test_in_kernel_dropout_stops_at_256():
    q = torch.zeros(1, 1, 4, 320)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="in-kernel dropout"):
        attention.fused_attention(q, q, q, causal=True, dropout_p=0.1,
                                  dropout_seed=seed)


def _segments(case, b, sq):
    """None, or segment ids whose padded query tail (id 0, no key of
    its own) makes fully masked rows."""
    if case == "causal":
        return None
    ids = np.ones((b, sq), np.int32)
    ids[:, sq // 2:] = 2
    q_ids = ids.copy()
    q_ids[:, -3:] = 0
    return q_ids, ids


@pytest.mark.parametrize("d", [264, 320])
@pytest.mark.parametrize("case", ["causal", "segments"])
def test_scores_route_matches_jax_dense_attention_and_its_vjp(d, case):
    rs = np.random.RandomState(d)
    b, h, s = 2, 3, 24
    q, k, v, do = (rs.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    segs = _segments(case, b, s)
    scale = d ** -0.5

    def jf(q_, k_, v_):
        seg = None if segs is None else tuple(map(jnp.asarray, segs))
        return jattn._dense_attention(q_, k_, v_, True, scale, seg)

    want, vjp = jax.vjp(jf, q, k, v)
    want_grads = vjp(jnp.asarray(do))
    calls = []
    kernel = tsm.scaled_masked_softmax

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)

    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    tsegs = None if segs is None else tuple(map(torch.from_numpy, segs))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "scaled_masked_softmax", counted)
        got = attention.fused_attention(*leaves, causal=True, sm_scale=scale,
                                        segment_ids=tsegs)
    got.backward(torch.from_numpy(do))
    assert calls == [1], "the scores route did not take the fused softmax"
    training._close_scaled(got, want, 1e-5, "out")
    for name, leaf, g in zip("qkv", leaves, want_grads):
        training._close_scaled(leaf.grad, g, 1e-5, f"d{name}")
    if segs is not None:   # the padded query rows see no key: exact zeros
        assert (got[:, :, -3:] == 0).all()
        assert np.all(np.asarray(want)[:, :, -3:] == 0)
        assert (leaves[0].grad[:, :, -3:] == 0).all()


def _jax_tree(kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_DISPATCH", "off")
        return jax.tree_util.tree_map(
            np.asarray, jserving.init_gpt_params(training._jax_config(kw)))


def _masks(kw, seed):
    """Keep masks of one step: 1 + 2L hidden ``[S, B, H]`` (the
    embedding's, then two per layer) and L probability ``[B, heads, S,
    S]`` (one per layer's scores path)."""
    rs = np.random.RandomState(300 + seed)
    hidden = (S, B, kw["hidden_size"])
    probs = (B, kw["num_attention_heads"], S, S)
    L = kw["num_layers"]
    return {hidden: rs.rand(1 + 2 * L, *hidden) >= P_DROP,
            probs: rs.rand(L, *probs) >= P_DROP}


def _jax_loss_and_grads(kw, tree, masks, monkeypatch):
    """JAX's per-token loss and gradients, flax's ``nn.Dropout`` taking
    the next mask of its shape's list (without masks, deterministic)."""
    used = dict.fromkeys(masks, 0)

    def bernoulli(key, p, shape):
        shape = tuple(shape)
        assert abs(p - (1 - P_DROP)) < 1e-12
        used[shape] += 1
        return masks[shape][used[shape] - 1]

    monkeypatch.setattr(flax_stochastic, "random",
                        types.SimpleNamespace(bernoulli=bernoulli))
    jm = JGPT(training._jax_config(kw))
    drop = dict(deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})

    def f(p, i, q, lab):
        def loss_fn(pp):
            per_tok = jm.apply({"params": pp}, i, q, None, lab,
                               **(drop if masks else {}))
            return jnp.mean(per_tok), per_tok
        (_, per_tok), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return per_tok, grads

    out = training._shmap(f, 4)(tree, *training._batch(kw=kw))
    assert all(used[shape] == len(m) for shape, m in masks.items()), used
    return out


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("d", sorted(WIDE))
def test_head_dim_past_256_matches_jax_fp32(d, dropout, monkeypatch):
    """A model whose heads are past the kernels' 256 trains (it was
    refused before): loss and every gradient against the JAX model within
    1e-4, through the scores route (and, with attention dropout, the
    scores path, whose softmax is the fused one's)."""
    kw = dict(WIDE[d], hidden_dropout=P_DROP if dropout else 0.0,
              attention_dropout=P_DROP if dropout else 0.0)
    assert TConfig(**kw).head_dim == d
    tree = _jax_tree(kw)
    masks = _masks(kw, d) if dropout else {}
    want = _jax_loss_and_grads(kw, tree, masks, monkeypatch)

    keys = {shape: {} for shape in masks}

    def keep_mask(generator, shape, p, device):
        shape = tuple(shape)
        key = int(torch.randint(0, 2 ** 62, (), generator=generator))
        i = keys[shape].setdefault(key, len(keys[shape]))
        return torch.from_numpy(masks[shape][i])

    monkeypatch.setattr(tutils, "keep_mask", keep_mask)
    calls = []
    kernel = tsm.scaled_masked_softmax

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(attention, "scaled_masked_softmax", counted)
    model = training._torch_model(tree, kw=kw)
    ids, pos, labels = training._tt(*training._batch(kw=kw))
    drop = {}
    if dropout:
        drop = dict(deterministic=False,
                    dropout_generator=torch.Generator().manual_seed(1))
    per_tok = model(ids, pos, None, labels, **drop)
    per_tok.mean().backward()
    # without dropout the scores route runs once a layer; with it the
    # scores path, whose fp32 softmax is the unfused one
    assert len(calls) == (0 if dropout else kw["num_layers"]), calls
    assert {s: len(k) for s, k in keys.items()} \
        == {s: len(m) for s, m in masks.items()}
    training._close_scaled(per_tok, want[0], 1e-4, "per_tok")
    flat = training._flat_jax(want[1])
    assert set(flat) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        training._close_scaled(p.grad, flat[name], 1e-4, name)


SERVE_KW = dict(hidden_size=1280, num_layers=2, num_attention_heads=4,
                vocab_size=128, max_position_embeddings=64,
                hidden_dropout=0.0, attention_dropout=0.0,
                apply_query_key_layer_scaling=False)
SERVE_ENGINE = dict(num_slots=2, page_size=8, num_pages=16, max_seq=64,
                    prefill_len=32)
SERVE_TRACE = dict(seed=5, n_requests=4, vocab=128, prompt_lo=3,
                   prompt_hi=14, new_lo=2, new_hi=8)


def test_engine_at_head_dim_320_matches_jax_token_for_token_fp32():
    jcfg, tcfg = JConfig(**SERVE_KW), TConfig(**SERVE_KW)
    assert tcfg.head_dim == 320
    tree = jax.tree_util.tree_map(np.asarray,
                                  jserving.init_gpt_params(jcfg))
    jreqs, jid = jsched.synthetic_trace(**SERVE_TRACE)
    treqs, tid = tsched.synthetic_trace(**SERVE_TRACE)
    assert jid == tid
    je = JEngine(jcfg, tree, **SERVE_ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(tree, tcfg, "cpu"),
                 device="cpu", **SERVE_ENGINE)
    jdone, tdone = je.run_trace(jreqs), te.run_trace(treqs)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
    assert (te.prefill_batches, te.decode_steps, te.tokens_generated) \
        == (je.prefill_batches, je.decode_steps, je.tokens_generated)


def test_engine_at_head_dim_576_matches_jax_token_for_token_fp32():
    """Past decode's 512 both engines serve: JAX's decode runs its jnp
    reference, the port's on the CPU its plain version (on the card the
    scores route, K10); prefill takes both packages' scores routes."""
    kw = dict(SERVE_KW, hidden_size=1152, num_attention_heads=2)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert tcfg.head_dim == 576
    tree = jax.tree_util.tree_map(np.asarray,
                                  jserving.init_gpt_params(jcfg))
    jreqs, jid = jsched.synthetic_trace(**SERVE_TRACE)
    treqs, tid = tsched.synthetic_trace(**SERVE_TRACE)
    assert jid == tid
    je = JEngine(jcfg, tree, **SERVE_ENGINE)
    te = TEngine(tcfg, tweights.from_jax_params(tree, tcfg, "cpu"),
                 device="cpu", **SERVE_ENGINE)
    jdone, tdone = je.run_trace(jreqs), te.run_trace(treqs)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
    assert (te.prefill_batches, te.decode_steps, te.tokens_generated) \
        == (je.prefill_batches, je.decode_steps, je.tokens_generated)
