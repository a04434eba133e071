"""Port parity: apex_tpu_torch.ops.attention (the plain version behind the
prefill kernel) against the JAX package's fused_attention on the same
numpy inputs — causal, packed segments with padding, and a fully masked
row. fp32 atol 1e-5 (same algorithm, summation order differs); bf16 atol
2e-2 (outputs are bf16: half an ulp at |x| < 4 is 7.8e-3, on each side).
And the head-dim pad the card path takes (``_kernel_head_dim``,
``_pad_head_dim``): the plain attention of zero-padded q, k, v, sliced
back, is the unpadded one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import attention_cuda

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, b, h, sq, sk, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, n, d).astype(np.float32) for n in (sq, sk, sk)]


def _run_both(q, k, v, dtype, causal, seg):
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jseg = None if seg is None else (jnp.asarray(seg[0]), jnp.asarray(seg[1]))
    tseg = None if seg is None else (torch.from_numpy(seg[0]),
                                     torch.from_numpy(seg[1]))
    ref = jattn.fused_attention(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)), causal=causal,
        segment_ids=jseg)
    out = tattn.fused_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=causal,
        segment_ids=tseg)
    assert out.dtype == td and tuple(out.shape) == q.shape
    return (np.asarray(ref.astype(jnp.float32)),
            out.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_jax(dtype):
    q, k, v = _inputs(0, 2, 3, 24, 24, 16)
    ref, out = _run_both(q, k, v, dtype, True, None)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_segments_with_padding_match_jax(dtype):
    """The prefill shape: 3 packed requests then padding on segment 0
    (padding attends to padding — no NaN there)."""
    q, k, v = _inputs(1, 1, 2, 32, 32, 16)
    seg = np.array([[1] * 7 + [2] * 12 + [3] * 5 + [0] * 8], np.int32)
    ref, out = _run_both(q, k, v, dtype, True, (seg, seg))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_gives_zero(dtype):
    """A query whose segment id appears in no key row is fully masked:
    both packages give exact zeros there."""
    q, k, v = _inputs(2, 2, 2, 8, 12, 16)
    seg_q = np.array([[1, 1, 2, 2, 9, 2, 1, 1]] * 2, np.int32)
    seg_kv = np.array([[1] * 6 + [2] * 6] * 2, np.int32)
    ref, out = _run_both(q, k, v, dtype, False, (seg_q, seg_kv))
    np.testing.assert_allclose(out, ref, atol=TOL[dtype])
    assert (out[:, :, 4] == 0).all() and (ref[:, :, 4] == 0).all()


@pytest.mark.parametrize("d,width", [(1, 64), (32, 64), (64, 64),
                                     (80, 128), (96, 128), (128, 128),
                                     (200, 256), (256, 256)])
def test_kernel_head_dim_is_the_next_kernel_width(d, width):
    assert tattn._kernel_head_dim(d) == width
    t = torch.ones(2, 3, d)
    padded = tattn._pad_head_dim(t, width)
    assert padded.shape == (2, 3, width) and padded.is_contiguous()
    assert torch.equal(padded[..., :d], t) and (padded[..., d:] == 0).all()
    assert tattn._pad_head_dim(t, d) is t
    assert torch.equal(tattn._slice_head_dim(padded, d), t)


def test_kernel_head_dim_refuses_past_256():
    with pytest.raises(ValueError, match="head_dim 257"):
        tattn._kernel_head_dim(257)


@pytest.mark.parametrize("d", [32, 80, 96, 200])
def test_head_dim_pad_is_exact(d):
    """Zero-padded to the kernel's width with the scale of the true head
    dim, the plain forward, sliced back, equals the unpadded one bit for
    bit, and so does dv; the padded columns of the output and of every
    gradient are exact zeros. dq and dk agree within 4 fp32 ulps of their
    scale: both sides form D = rowsum(dO * O) over the row, and the CPU
    sums 80 terms and 128 (80 and 48 zeros) in another vector order."""
    rs = np.random.RandomState(d)
    q, k, v, g = (torch.from_numpy(rs.randn(2, 3, 40, d).astype(np.float32))
                  for _ in range(4))
    seg_ids = torch.from_numpy(np.sort(rs.randint(0, 3, (2, 40)), axis=1)
                               .astype(np.int32))
    seg = (seg_ids, seg_ids)
    width = tattn._kernel_head_dim(d)
    scale = d ** -0.5
    pq, pk, pv, pg = (tattn._pad_head_dim(t, width) for t in (q, k, v, g))
    o = tattn._dense_attention(q, k, v, True, scale, seg)
    po = tattn._dense_attention(pq, pk, pv, True, scale, seg)
    assert torch.equal(po[..., :d], o) and (po[..., d:] == 0).all()
    grads = tattn._attention_bwd_split(q, k, v, o, g, True, scale, seg)
    pgrads = tattn._attention_bwd_split(pq, pk, pv, po, pg, True, scale, seg)
    for name, got, want in zip("qkv", pgrads, grads):
        assert (got[..., d:] == 0).all(), f"d{name} padded columns"
        if name == "v":
            assert torch.equal(got[..., :d], want)
        else:
            atol = 4 * 2.0 ** -23 * want.abs().max().item()
            torch.testing.assert_close(got[..., :d], want, atol=atol, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """On CPU tensors the wrapper runs the plain version; the kernel's
    launch counter moves only where the kernel launches."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 2, 8, 8, 16))
    before = attention_cuda.prefill_attention.launches
    out = tattn.fused_attention(q, k, v, causal=True)
    ref = tattn._dense_attention(q, k, v, True, 0.25, None)
    assert attention_cuda.prefill_attention.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: handed CPU
    tensors it raises instead of falling back."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 1, 1, 4, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.prefill_attention(q, k, v, causal=True,
                                          sm_scale=0.125)
