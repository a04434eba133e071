"""Port parity: apex_tpu_torch.ops.decode_attention (the plain version
behind the paged decode kernel) against the JAX package's
decode_attention_reference and its Pallas kernel in interpret mode, on
the same numpy inputs: lengths 0 / 1 / ps / ps+1 / a multi-page tail and
a page table padded with null page 0, at head dims 16 to 512 (the
kernels' buckets are 64, 128, 256 and 512; the plain version takes any),
and the scores route the card takes past 512 at d = 576, over bf16 and
over int8 pages. fp32 atol 1e-5 (same algorithm, summation order
differs); bf16 atol 2e-2 (outputs are bf16: one ulp at |x| < 4 is
1.6e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import decode_attention_pallas as jdap
from apex_tpu.serving import kv_tier as jtier
from apex_tpu_torch.ops import decode_attention as tdap
from apex_tpu_torch.ops import decode_attention_cuda

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PS, H, D, PAGES, MAX_PAGES = 8, 2, 16, 12, 4
LENGTHS = np.array([0, 1, PS, PS + 1, 2 * PS + 3], np.int32)


def _inputs(seed, d=D):
    rs = np.random.RandomState(seed)
    b = len(LENGTHS)
    q = rs.randn(b, H, d).astype(np.float32)
    kp = rs.randn(H, PAGES, PS, d).astype(np.float32)
    vp = rs.randn(H, PAGES, PS, d).astype(np.float32)
    # distinct live pages per slot, tails padded with the null page 0
    pt = np.zeros((b, MAX_PAGES), np.int32)
    nxt = 1
    for i, n in enumerate(LENGTHS):
        for j in range(-(-int(n) // PS)):
            pt[i, j] = nxt
            nxt += 1
    return q, kp, vp, pt


def _port(q, kp, vp, pt, dtype):
    td = getattr(torch, dtype)
    out = tdap.decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
        torch.from_numpy(vp).to(td), torch.from_numpy(pt),
        torch.from_numpy(LENGTHS), sm_scale=q.shape[-1] ** -0.5)
    assert out.dtype == td and tuple(out.shape) == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("d", [D, 32, 80, 256, 512])
def test_matches_jax(dtype, oracle, d):
    q, kp, vp, pt = _inputs(0, d)
    jd = getattr(jnp, dtype)
    args = [jnp.asarray(x).astype(jd) for x in (q, kp, vp)] + [
        jnp.asarray(pt), jnp.asarray(LENGTHS)]
    if oracle == "reference":
        ref = jdap.decode_attention_reference(*args, d ** -0.5)
    else:
        assert jdap.supported(H, PAGES, PS, d, jd)
        ref = jdap.decode_attention_pallas(*args, d ** -0.5,
                                           interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = _port(q, kp, vp, pt, dtype)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype])
    assert (out[0] == 0).all(), "an inactive slot (length 0) gives 0"


def test_pages_past_each_length_do_not_change_the_result():
    """Rewriting every page no slot holds live rows in (the null page
    included) changes nothing: positions at or past each length are
    masked out of the softmax and the value sum. (The plain version
    gathers them and multiplies by 0, so the poison here is finite; the
    card test poisons with NaN to show the kernel never reads them.)"""
    q, kp, vp, pt = _inputs(1)
    clean = _port(q, kp, vp, pt, "float32")
    live = {int(pt[i, j]) for i, n in enumerate(LENGTHS)
            for j in range(-(-int(n) // PS))}
    for p in set(range(PAGES)) - live:
        kp[:, p] = 1e4
        vp[:, p] = -1e4
    np.testing.assert_array_equal(_port(q, kp, vp, pt, "float32"), clean)


def test_int8_pages_raise():
    q, kp, vp, pt = _inputs(2)
    with pytest.raises(ValueError, match="int8"):
        tdap.decode_attention(
            torch.from_numpy(q), torch.zeros(kp.shape, dtype=torch.int8),
            torch.zeros(vp.shape, dtype=torch.int8), torch.from_numpy(pt),
            torch.from_numpy(LENGTHS))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, kp, vp, pt = _inputs(3)
    before = decode_attention_cuda.decode_attention.launches
    _port(q, kp, vp, pt, "float32")
    assert decode_attention_cuda.decode_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda.decode_attention(
            *(torch.from_numpy(x) for x in (q, kp, vp, pt, LENGTHS)),
            sm_scale=0.25)


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_scores_route_past_512_matches_jax_reference(pages):
    """At d = 576, past the kernels' 512, the card runs
    ``decode_scores_attention`` (matmul scores, K10 with a key-padding
    mask, matmul context); on the CPU, through the plain softmax, it
    matches JAX's ``decode_attention_reference``, the route JAX takes
    there (``supported`` is false past 512), over bf16 pages and over
    the int8 tier's codes with their scales; the CPU's own call keeps the
    plain version."""
    d = 576
    q, kp, vp, pt = _inputs(4, d)
    assert not jdap.supported(H, PAGES, PS, d, jnp.bfloat16)
    assert d > decode_attention_cuda.MAX_HEAD_DIM
    targs = [torch.from_numpy(pt), torch.from_numpy(LENGTHS)]
    jargs = [jnp.asarray(pt), jnp.asarray(LENGTHS)]
    if pages == "bfloat16":
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp))
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, kp, vp))
        scales, jscales, tol = {}, {}, TOL["bfloat16"]
    else:
        ks = jnp.asarray(np.abs(kp).max(axis=(-2, -1)) / 127.0, jnp.bfloat16)
        vs = jnp.asarray(np.abs(vp).max(axis=(-2, -1)) / 127.0, jnp.bfloat16)
        jq = jnp.asarray(q)
        jk, jv = (jtier.quantize(jnp.asarray(x), s)
                  for x, s in ((kp, ks), (vp, vs)))
        tq = torch.from_numpy(q)
        tk, tv = (torch.from_numpy(np.asarray(x)) for x in (jk, jv))
        jscales = dict(k_scale=ks, v_scale=vs)
        scales = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
            torch.bfloat16) for k, v in jscales.items()}
        tol = TOL["float32"]
    want = np.asarray(jdap.decode_attention_reference(
        jq, jk, jv, *jargs, d ** -0.5, **jscales).astype(jnp.float32))
    got = tdap.decode_scores_attention(tq, tk, tv, *targs, d ** -0.5,
                                       scales.get("k_scale"),
                                       scales.get("v_scale"))
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    assert (got[0] == 0).all(), "an inactive slot (length 0) gives 0"
    plain = tdap.decode_attention(tq, tk, tv, *targs, sm_scale=d ** -0.5,
                                  **scales)
    np.testing.assert_array_equal(
        plain.float().numpy(), tdap.decode_attention_reference(
            tq, tk, tv, *targs, d ** -0.5, scales.get("k_scale"),
            scales.get("v_scale")).float().numpy())
