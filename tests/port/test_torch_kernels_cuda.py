"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the chip smoke does not reach: ragged tiles, head
dims 64 and 128, bf16/fp16/fp32, fully masked rows, lengths 0 / 1 /
ps-1 / ps / ps+1 / full, and unowned pages poisoned with NaN.

Marked ``cuda``: each test needs a card and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/port/test_torch_kernels_cuda.py -q

Tolerances: fp32 1e-4 (same math, fp32 sums in another order); fp16
5e-3 and bf16 5e-2 (outputs round to the half type; the plain prefill
version also rounds its probabilities to the half type before the value
product).
"""

import pytest
import torch

from apex_tpu_torch.ops import attention, attention_cuda
from apex_tpu_torch.ops import decode_attention, decode_attention_cuda

pytestmark = pytest.mark.cuda

DTYPES = {"bfloat16": (torch.bfloat16, 5e-2), "float16": (torch.float16, 5e-3),
          "float32": (torch.float32, 1e-4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["causal", "segments", "masked_row",
                                  "cross"])
def test_prefill_kernel_matches_plain(dev, dtype, d, case):
    torch_dtype, tol = DTYPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h = 2, 3
    sq, sk = (100, 100) if case != "cross" else (70, 133)
    q = _randn(gen, b, h, sq, d, dtype=torch_dtype, dev=dev)
    k, v = (_randn(gen, b, h, sk, d, dtype=torch_dtype, dev=dev)
            for _ in range(2))
    causal = case in ("causal", "segments")
    seg = None
    if case == "segments":
        s = torch.zeros(b, sq, dtype=torch.int32)
        s[:, :37], s[:, 37:81] = 1, 2              # 81.. is padding (0)
        seg = (s.to(dev), s.to(dev))
    elif case in ("masked_row", "cross"):
        sq_ids = torch.ones(b, sq, dtype=torch.int32)
        sq_ids[:, sq // 2:] = 2
        sq_ids[:, 5] = 9                           # no key carries 9
        kv_ids = torch.ones(b, sk, dtype=torch.int32)
        kv_ids[:, sk // 2:] = 2
        seg = (sq_ids.to(dev), kv_ids.to(dev))
    scale = d ** -0.5
    before = attention_cuda.prefill_attention.launches
    out = attention.fused_attention(q, k, v, causal=causal, sm_scale=scale,
                                    segment_ids=seg)
    assert attention_cuda.prefill_attention.launches == before + 1
    ref = attention._dense_attention(q, k, v, causal, scale, seg)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    if seg is not None and case != "segments":
        assert (out[:, :, 5] == 0).all(), "a fully masked row gives 0"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ps", [16, 128])
def test_decode_kernel_matches_plain_and_reads_only_live_pages(dev, dtype,
                                                               d, ps):
    torch_dtype, tol = DTYPES[dtype]
    tol = min(tol, 2e-2)            # no probability rounding in the plain
    gen = torch.Generator(device=dev).manual_seed(1)
    max_pages, h = 5, 4
    lengths_l = [0, 1, ps - 1, ps, ps + 1, max_pages * ps, 3 * ps + 2]
    b = len(lengths_l)
    pages = 2 + sum(-(-n // ps) for n in lengths_l)
    q = _randn(gen, b, h, d, dtype=torch_dtype, dev=dev)
    kp, vp = (_randn(gen, h, pages, ps, d, dtype=torch_dtype, dev=dev)
              for _ in range(2))
    pt = torch.zeros(b, max_pages, dtype=torch.int32)
    live = set()
    nxt = pages - 1                 # hand pages out from the top down
    for i, n in enumerate(lengths_l):
        for j in range(-(-n // ps)):
            pt[i, j] = nxt
            live.add(nxt)
            nxt -= 1
    pt = pt.to(dev)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    ref = decode_attention.decode_attention_reference(q, kp, vp, pt,
                                                      lengths, d ** -0.5)
    # poison every page no slot holds live rows in (null page 0 too):
    # the kernel must never read them
    for p in set(range(pages)) - live:
        kp[:, p] = float("nan")
        vp[:, p] = float("nan")
    before = decode_attention_cuda.decode_attention.launches
    out = decode_attention.decode_attention(q, kp, vp, pt, lengths,
                                            sm_scale=d ** -0.5)
    assert decode_attention_cuda.decode_attention.launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert (out[0] == 0).all(), "an inactive slot gives 0"


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_cuda.prefill_attention(q, q, q, causal=True, sm_scale=1.0)
    q64 = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.prefill_attention(q64.transpose(1, 2), q64, q64,
                                          causal=True, sm_scale=1.0)
    pages = torch.zeros(2, 4, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="page_table"):
        decode_attention_cuda.decode_attention(
            torch.zeros(1, 2, 64, device=dev, dtype=torch.bfloat16), pages,
            pages, torch.zeros(1, 4, dtype=torch.int64, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev), sm_scale=1.0)
