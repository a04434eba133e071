"""Port parity of the attention backward: the plain split backward
``apex_tpu_torch.ops.attention._attention_bwd_split`` (the plain version
of K5 and K6) and the autograd path of ``fused_attention`` against the
JAX package's rows kernel with the split backward
(``fused_attention_rows(..., interpret=True, bwd_impl="split")``, run as
tests/test_attention_pallas.py runs it) and against ``jax.vjp`` of its
``_dense_attention``, on the same numpy inputs and cotangent.

Cases: causal, causal with packed segment ids, segment ids with fully
masked query rows (a query segment no key carries), and sq != sk; and
``fused_attention``'s forward and backward at head dims 32, 80, 96 and
256 (the kernels' widths and the ones they zero-pad) against the rows
kernel, fp32 within 1e-4.
Tolerances: fp32 2e-4 and bf16 4e-2, the bands of
tests/test_attention_pallas.py's split-backward tests (the plain version
takes D = rowsum(dO * O) from the forward output where the TPU kernel
forms rowsum(P * dP); they agree in exact arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention_pallas as ap
from apex_tpu.ops.attention import _dense_attention as jdense
from apex_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}
CASES = {
    # name: (sq, sk, causal, segments)
    "causal": (256, 256, True, None),
    "causal_segments": (256, 256, True, "packed"),
    "masked_rows": (128, 256, False, "missing"),
    "cross": (128, 256, False, None),
}


def _inputs(case, seed=0):
    sq, sk, causal, segs = CASES[case]
    b, h, d = 1, 2, 32
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, sq, d).astype(np.float32)
    k = rs.randn(b, h, sk, d).astype(np.float32)
    v = rs.randn(b, h, sk, d).astype(np.float32)
    g = rs.randn(b, h, sq, d).astype(np.float32)
    seg = None
    if segs == "packed":
        ids = np.sort(rs.randint(0, 3, (b, sq)), axis=1).astype(np.int32)
        seg = (ids, ids)
    elif segs == "missing":
        seg_q = np.sort(rs.randint(0, 3, (b, sq)), axis=1).astype(np.int32)
        seg_kv = rs.randint(0, 2, (b, sk)).astype(np.int32)  # no segment 2
        seg = (seg_q, seg_kv)
    return q, k, v, g, causal, seg


def _jax_grads(fn, q, k, v, g, jdt):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return vjp(jnp.asarray(g, jdt))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_split_backward_matches_the_rows_kernel(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, g, causal, seg = _inputs(case)
    d = q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    jseg = None if seg is None else tuple(jnp.asarray(s) for s in seg)
    tseg = None if seg is None else tuple(torch.from_numpy(s) for s in seg)
    assert ap.supported(q.shape[2], k.shape[2], d)
    rows = _jax_grads(
        lambda q_, k_, v_: ap.fused_attention_rows(
            q_, k_, v_, causal, scale, jseg, True, None, "split"),
        q, k, v, g, jdt)
    dense = _jax_grads(
        lambda q_, k_, v_: jdense(q_, k_, v_, causal, scale, jseg),
        q, k, v, g, jdt)

    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o = tattn._dense_attention(tq, tk, tv, causal, scale, tseg)
    plain = tattn._attention_bwd_split(tq, tk, tv, o, tg, causal, scale,
                                       tseg)
    for got, want_rows, want_dense in zip(plain, rows, dense):
        assert got.dtype == tdt and got.shape == want_rows.shape
        _close(got, want_rows, tol)
        _close(got, want_dense, tol)
    if case == "masked_rows":
        dead = seg[0][0] == 2                   # queries no key can see
        assert dead.any()
        assert (plain[0][0][:, torch.from_numpy(dead)] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_autograd_path_runs_the_split_backward(dtype):
    """``fused_attention`` with inputs that need gradients: the forward
    equals the plain forward and the backward equals the plain split
    backward exactly (the CPU path runs those very functions)."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, g, causal, seg = _inputs("causal_segments", seed=1)
    tseg = tuple(torch.from_numpy(s) for s in seg)
    scale = 0.125
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tattn.fused_attention(*leaves, causal=True, sm_scale=scale,
                                segment_ids=tseg)
    out.backward(tg)
    o = tattn._dense_attention(tq, tk, tv, True, scale, tseg)
    assert torch.equal(out.detach(), o)
    want = tattn._attention_bwd_split(tq, tk, tv, o, tg, True, scale, tseg)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    jseg = tuple(jnp.asarray(s) for s in seg)
    dense = _jax_grads(
        lambda q_, k_, v_: jdense(q_, k_, v_, True, scale, jseg),
        q, k, v, g, jdt)
    for leaf, w in zip(leaves, dense):
        _close(leaf.grad, w, tol)


@pytest.mark.parametrize("d", [32, 80, 96, 256])
def test_fused_attention_matches_the_rows_kernel_at_head_dims(d):
    """The port's ``fused_attention`` (forward, and the backward through
    autograd) against the JAX rows kernel in interpret mode with the split
    backward (its dense path where ``supported`` refuses the shape), fp32
    within 1e-4, on packed causal segments."""
    b, h, s = 1, 2, 128
    rs = np.random.RandomState(d)
    q, k, v, g = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    ids = np.sort(rs.randint(0, 3, (b, s)), axis=1).astype(np.int32)
    scale = 1.0 / np.sqrt(d)
    jseg = (jnp.asarray(ids), jnp.asarray(ids))
    if ap.supported(s, s, d):
        def jfn(q_, k_, v_):
            return ap.fused_attention_rows(q_, k_, v_, True, scale, jseg,
                                           True, None, "split")
    else:
        def jfn(q_, k_, v_):
            return jdense(q_, k_, v_, True, scale, jseg)
    jo, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))

    tseg = (torch.from_numpy(ids), torch.from_numpy(ids))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.fused_attention(*leaves, causal=True, segment_ids=tseg)
    out.backward(torch.from_numpy(g))
    assert out.shape == (b, h, s, d)
    _close(out, jo, 1e-4)
    for leaf, want in zip(leaves, jgrads):
        assert leaf.grad.shape == (b, h, s, d)
        _close(leaf.grad, want, 1e-4)


def test_inputs_without_gradients_save_nothing():
    q = torch.randn(1, 1, 8, 16)
    out = tattn.fused_attention(q, q, q, causal=True)
    assert out.grad_fn is None
