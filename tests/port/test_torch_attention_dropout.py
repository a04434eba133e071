"""Port parity of in-kernel attention dropout: the plain mask
``apex_tpu_torch.ops.attention.dropout_mscale`` against the JAX package's
``attention_pallas._dropout_mscale`` (a plain jnp function), and the plain
attention with dropout (``_dense_attention`` and ``_attention_bwd_split``
with ``dropout_p``, the plain versions of K1d and K5d/K6d) and the
autograd path of ``fused_attention`` against the rows kernel with dropout,
``fused_attention_rows(..., interpret=True, dropout_p=0.1)`` and its
``jax.vjp`` (the monolithic backward's dropout replay), run as
tests/test_attention_pallas.py runs it.

The JAX call uses ``block_q=64`` at s = 256, so its grid spans four q
blocks: a mask built from tile-local row indices would show there.
Tolerances: the mask equal in every element; fp32 within 1e-5 (output)
and 1e-4 (dq, dk, dv) of each tensor's largest magnitude (the same fp32
math; the plain backward takes D = rowsum(dO * O) where the TPU kernel
forms rowsum(P mscale * dP), equal in exact arithmetic); bf16 within
4e-2, the band of test_torch_attention_bwd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention_pallas as ap
from apex_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

SEEDS = [0, 1, -1, -2 ** 31, 2 ** 31 - 1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seed(value):
    return torch.tensor([value], dtype=torch.int32)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The tests here run torch on one intra-op thread. At two, under the
    load of a parallel test run, the first evaluation of the plain
    attention in a process could differ in the last bit from every later
    one (seen in 2 of 12 loaded processes; at one thread in none of 24),
    and the first bf16 case holds two evaluations equal bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_mask_equals_the_jax_hash_in_every_element(seed, p):
    b, h, rows, sk = 2, 3, 48, 80
    for row0, col0 in ((0, 0), (192, 64)):
        got = tattn.dropout_mscale(_seed(seed), b, h, rows, sk, p,
                                   row0=row0, col0=col0)
        assert got.dtype == torch.float32 and got.shape == (b, h, rows, sk)
        for ib in range(b):
            for ih in range(h):
                want = np.asarray(ap._dropout_mscale(
                    jnp.int32(seed), ib, ih, row0, rows, sk, p, h, col0))
                assert np.array_equal(got[ib, ih].numpy(), want), (ib, ih)


def test_mask_constants_and_kept_fraction():
    assert tattn.dropout_threshold(0.1) == 429496729
    assert tattn.dropout_scale(0.1) == np.float32(1.0 / 0.9)
    m = tattn.dropout_mscale(_seed(-7), 4, 4, 256, 256, 0.1)
    n = m.numel()
    kept = int((m > 0).sum())
    sigma = (n * 0.1 * 0.9) ** 0.5
    assert abs(kept - 0.9 * n) <= 5 * sigma
    assert set(m.unique().tolist()) == {0.0, tattn.dropout_scale(0.1)}
    # another seed, another mask
    assert not torch.equal(m, tattn.dropout_mscale(_seed(-6), 4, 4, 256,
                                                   256, 0.1))


def _inputs(segmented, seed=0):
    b, h, s, d = 2, 2, 256, 32
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    seg = None
    if segmented:
        ids = np.sort(rs.randint(0, 3, (b, s)), axis=1).astype(np.int32)
        seg = (ids, ids)
    return q, k, v, g, seg


def _close_scaled(got, want, rel, name):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    atol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("segmented", [False, True],
                         ids=["causal", "segmented"])
def test_forward_and_backward_match_the_rows_kernel(segmented, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, g, seg = _inputs(segmented)
    seed, p, scale = -1234567, 0.1, 1.0 / np.sqrt(q.shape[-1])
    jseg = None if seg is None else tuple(jnp.asarray(x) for x in seg)
    tseg = None if seg is None else tuple(torch.from_numpy(x) for x in seg)
    assert ap.supported(256, 256, 32, dropout=True)
    jseed = jnp.asarray([[seed]], jnp.int32)
    o_j, vjp = jax.vjp(
        lambda q_, k_, v_: ap.fused_attention_rows(
            q_, k_, v_, True, scale, jseg, True, 64, None, p, jseed),
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads_j = vjp(jnp.asarray(g, jdt))

    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tattn.fused_attention(*leaves, causal=True, sm_scale=scale,
                                segment_ids=tseg, dropout_p=p,
                                dropout_seed=_seed(seed))
    out.backward(tg)
    # the autograd path runs exactly the plain versions on the CPU
    o = tattn._dense_attention(tq, tk, tv, True, scale, tseg, p, _seed(seed))
    assert torch.equal(out.detach(), o), "o"
    plain = tattn._attention_bwd_split(tq, tk, tv, o, tg, True, scale, tseg,
                                       p, _seed(seed))
    for name, leaf, want in zip("qkv", leaves, plain):
        assert leaf.grad.dtype == tdt and torch.equal(leaf.grad, want), name

    if dtype == "float32":
        _close_scaled(out, o_j, 1e-5, "o")
        for name, leaf, want in zip("qkv", leaves, grads_j):
            _close_scaled(leaf.grad, want, 1e-4, "d" + name)
    else:
        np.testing.assert_allclose(out.detach().float().numpy(),
                                   np.asarray(o_j, np.float32), atol=4e-2,
                                   rtol=0, err_msg="o")
        for name, leaf, want in zip("qkv", leaves, grads_j):
            np.testing.assert_allclose(leaf.grad.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=4e-2, rtol=0, err_msg="d" + name)
    # dropout changes the function: the output differs from no dropout
    assert not torch.allclose(o, tattn._dense_attention(tq, tk, tv, True,
                                                        scale, tseg))


def test_dropout_p_zero_is_the_function_without_dropout():
    q, k, v, g, seg = _inputs(True, seed=1)
    tseg = tuple(torch.from_numpy(x) for x in seg)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    outs = []
    for kw in ({}, dict(dropout_p=0.0), dict(dropout_p=0.0,
                                             dropout_seed=_seed(5))):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = tattn.fused_attention(*leaves, causal=True, segment_ids=tseg,
                                    **kw)
        out.backward(tg)
        outs.append([out.detach()] + [x.grad for x in leaves])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_fused_attention_refuses_bad_dropout_arguments():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match=r"outside \[0, 1\)"):
        tattn.fused_attention(q, q, q, causal=True, dropout_p=1.0,
                              dropout_seed=_seed(0))
    with pytest.raises(ValueError, match=r"outside \[0, 1\)"):
        tattn.fused_attention(q, q, q, causal=True, dropout_p=-0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        tattn.fused_attention(q, q, q, causal=True, dropout_p=0.1)
