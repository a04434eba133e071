"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the chip smoke does not reach: ragged tiles, head
dims 32 / 64 / 80 / 96 / 128 / 256 for the attention kernels (the
widths between the kernels' 64, 128 and 256 zero-padded) and 32 / 64 /
80 / 128 / 256 / 512 for decode, bf16/fp16/fp32, fully masked rows,
lengths 0 / 1 / ps-1 / ps / ps+1 / full, unowned pages poisoned with
NaN; the split-KV decode kernels K2/K2q at their split boundaries (sk -
1, sk, sk + 1 keys, several splits a page), over fragmented page tables
with out-of-range entries, element-by-element page copies, three runs
equal bit for bit, and launches on two streams at once; decode past
head dim 512 launching K10 and not K2 or K2q; layer norm at ragged row
counts and 8193 rows (past the persistent grids), hidden 6 / 12 / 36 /
100 / 200 and 64 / 768 / 1024 (the rows body's vector widths), 4096 /
8192 (the team body), 12288 and 12800 (the wide body, 12800 past its
registers), with and without affine, two K4 runs equal bit for bit on
every body, and ``FusedLayerNorm((64, 200))``;
the prefill forward K1 and K1d in bf16 and fp16 (the
tensor-core body) over several ragged and exact tiles (300 x 300, 200 x
333, 256 x 256) causal, segmented with a padded tail, with dropout and
non-causal, two runs equal bit for bit, fp32 on its CUDA-core body (the
names the profiler records), the half-type K1d's mask recovered where it
keeps; the split attention backward (K5, K6) on causal,
segmented, fully masked and cross-length inputs, and in bf16 and fp16
(the tensor-core kernels) over several ragged and exact tiles (300 x
300, 200 x 333, 256 x 256) causal, segmented and with dropout, two runs
equal bit for bit, and fp32 on its own CUDA-core kernels (the names the
profiler records), at head dim 256 the two-warpgroup tensor-core bodies
(their names, two runs equal bit for bit); attention past head dim 256
on the scores route, K10 and K11 launching once each and no attention
kernel; the fused LM head (K7,
K8, K9) at vocabularies 384, 640, 1280 and 50304, row counts that leave
partial row tiles, widths that leave a partial column tile or narrower
warpgroup windows, a width the tensor-core K8/K9 do not take (their
general form), with and without label smoothing, two K8 runs and two K9
runs equal bit for bit; K7 and K7p on each of their forms (the
tensor-core body, wmma, fp32) with labels at 0, at V - 1, in the range
of the zero-filled columns past V, past them and negative, two runs of
each equal bit for bit; the dropout variants K1d, K5d and K6d at
lengths that leave partial tiles (200), causal and segmented, with
negative and extreme seeds, the mask recovered exactly from K1d's output
with V the identity, and K5d/K6d repeatable bit for bit; K2q (decode over
the int8 KV tier's pages) at K2's edge lengths with the scales of unowned
pages poisoned with NaN, and against K2 over the dequantized pages; K1d,
K5d and K6d non-causal with BERT's padding segment ids at 200, 333 and
512; a bf16 ``BertModel`` launching K10/K11 deterministic and
K1d/K5d/K6d with dropout; K10 and K11 under BERT's padding masks (the
extended ``[b, 1, s, s]`` one and a key padding with an empty row); the
fused softmax K10 (causal, a ``[b, 1, sq, sk]`` and a ``[b, np, sq, sk]``
mask with a fully masked row, a key-padding ``[b, 1, 1, sk]`` mask, none;
two runs equal bit for bit, causal and masked) and K11 at row lengths
that take the vector loads (128, 1024, 4096) and the element loads (200,
3000), and ``FusedScaleMaskSoftmax`` on the card
launching K10 for a key-padding mask and raising for a mask it cannot
take; the long-row K10L and K11L at 4097 (element loads), 5000 and 8192
keys and at the edges of each of K10L's bodies (``long_plan``: the
register body for bf16/fp16 to 8192 keys, the shared-memory body to 24576
fp32 and 49152 bf16/fp16 keys, the walking body past them), two K10L runs
equal bit for bit on each body, and the generic softmax launching them;
the serving engine's decode program replayed as a CUDA graph giving the
eager program's tokens bit for bit, K = 1 and 4, greedy and sampled, over
bf16 and int8 KV pages; the vocabulary-shard head
K7p on every shard of a table split over 2 or 4 ranks, its partials
against their plain version and, combined in a fixed order, against K7
on the whole table, with K8 and K9 on each shard (``v_total`` the whole
vocabulary) against their plain versions, the shards' dX summed and
their dE stacked against K8 and K9 on the whole table; K16 (SGD) bit
for bit against the plain update and selects over three steps and a
skipped one, in every dtype pair, past one launch's table, and its
four-list form writing the model copy in bf16, fp16 and fp32; K17 and
K18 (batch norm) against their plain versions, in their one-launch forms
(one rank) and their two-launch forms (a group's), at rows that take
16-byte vectors or single channels, one tile or several, a partial tile,
one row, ResNet-50's widest rows, a prime row count, C = 100 and more
channel tiles than the card holds blocks, with and without the fused
ReLU, each launch twice the same bits, in eval, without scale and bias,
with scale and bias in another dtype than x, from a pointer off a
16-byte boundary, every kernel's plan within what the card holds, and
``SyncBatchNorm`` on the card launching K17 and K18 once each in one
launch and raising on a channels-first activation; K19 (the int8 block quantizer
with error feedback) bit for bit against its plain version at BERT-large's
flat gradient size and at n = 1, 127, 300, rows of 501 (the element
loads), all-zero, inf and NaN blocks, without a residual and with one (the
residual only read, the new one a tensor of its own); K20 (dequantize and sum)
bit for bit at W = 2 and 4 in rank order, with the division by W and in
the gather form; both at blocks 32, 64, 256, 1, 3, 100 and 1000; K21 (the ZeRO Adam shard update) bit for bit against its
plain version and against K14 on the same fp32 shard, a skipped step
writing nothing of the state; K22 (the ZeRO LAMB shard update) against
its plain version, the moments and direction bit for bit, the segment
sums and the update within ``MT_LAMB_TOL`` relative, on a layout with
the padding segment and a tensor straddling the shard boundary; and the
ZeRO transforms and the codec launching them once a step on one rank;
K23 (the W8A16 decode matmul) against its plain version at GPT-2-small's
five decode shapes at 8 rows and at edges (one row, partial and several
8-row tiles, N past a 16-channel tile, K of one 16-column step, past a
64-column chunk by one and three steps and past a 512-column chunk, B of
9, 17 and 40, all-zero weight rows), the tensor-core body on forced
plans (unsplit, K split over a block's warps, over a cluster's blocks,
both, spare n-tiles), two runs equal bit for bit, an x off a 16-byte
boundary giving the aligned x's bits, its wrapper refusing what it or
its plan does not take, the five decode shapes captured in a
CUDA graph and replayed twice to the eager bits, and a weight-quant
engine launching it 4 x layers + 1 times a decode call, its graphed
tokens the eager ones; K23 at K 8, 24, 100 and 770 (not multiples of 16)
on the plan's launch and forced element-load plans, with a wq off a
16-byte boundary, the two tensor-core forms the same bits at a K both
take, and an engine at hidden 100 serving its plain path's tokens.

Marked ``cuda``: each test needs a card and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/port/test_torch_kernels_cuda.py -q

Tolerances: fp32 1e-4 (same math, fp32 sums in another order); fp16
5e-3 and bf16 5e-2 (outputs round to the half type; the plain prefill
version also rounds its probabilities to the half type before the value
product; the backward rounds dS and P to the half type on both sides,
and a one-ulp flip there moves a gradient by under 1e-2 of its scale).
Layer-norm statistics and the fp32 affine gradients: 1e-4 relative to
their scale (fp32 sums over the row or over the rows, another order).
The layer-norm outputs and the attention gradients are also held by
their relative L2 error (``L2_TOL``), and K1/K1d's outputs by
``K1_L2_TOL``, so an error the size of a typical element fails even
where one large element widens the band above. The
LM head's loss and lse are fp32 on both sides from logits summed in
another order: within ``XENT_LOSS_TOL`` of max(1, |loss|). Its dX and dE
have their own relative-L2 band, ``XENT_L2_TOL``: both sides round the
softmax coefficients to the half type from fp32 logits summed in another
order, and at V = 50304 a row has tens of thousands of them, so more
roundings flip than in the attention backward.
"""

import contextlib
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from apex_tpu_torch.ops import attention, attention_bwd_cuda, attention_cuda
from apex_tpu_torch.ops import decode_attention, decode_attention_cuda
from apex_tpu_torch.ops import _build, multi_tensor, multi_tensor_cuda
from apex_tpu_torch.ops import layer_norm, layer_norm_cuda
from apex_tpu_torch.ops import softmax, softmax_cuda
from apex_tpu_torch.ops import xent, xent_cuda
from apex_tpu_torch.serving import (Request, ServingEngine, kv_tier,
                                    synthetic_trace)
from apex_tpu_torch.serving import sampling
from apex_tpu_torch.serving.weights import init_gpt_params
from apex_tpu_torch.transformer.testing import TransformerConfig

pytestmark = pytest.mark.cuda

DTYPES = {"bfloat16": (torch.bfloat16, 5e-2), "float16": (torch.float16, 5e-3),
          "float32": (torch.float32, 1e-4)}
# relative L2 of a layer-norm or attention-backward output against the
# plain version. Both sides round at the same points, so most elements
# round to the same value; on an H100 (tests/port/kernel_l2_errors.py)
# these cases measured at most 1.2e-4 (bf16), 3.3e-5 (fp16) and 4.5e-7
# (fp32) with K5/K6 on the CUDA cores, and 1.1e-4 (bf16) and 6.6e-5
# (fp16) with K5/K6 on the tensor cores, the multi-tile cases included;
# with the D = 256 bodies on the tensor cores too, 3.1e-4 (bf16, d = 96),
# 7.8e-5 (fp16) and 6.3e-7 (fp32), at d = 256 1.3e-4 (bf16)
L2_TOL = {"bfloat16": 1e-3, "float16": 3e-4, "float32": 5e-6}
# on an H100 (tests/port/kernel_l2_errors.py) these cases measured at most
# 3.1e-7 for the loss and lse of every dtype (with K7 on wmma, and 3.1e-7
# with K7 on wgmma, the edge-label cases included), and 5.8e-4 (bf16),
# 2.1e-4 (fp16) and 4.2e-6 (fp32) for dX and dE, both with K8/K9 on wmma
# and on wgmma (bf16/fp16; fp32 keeps its CUDA-core form)
XENT_LOSS_TOL = 2e-6
XENT_L2_TOL = {"bfloat16": 2e-3, "float16": 6e-4, "float32": 1.5e-5}
# relative L2 of a dropout-backward output (K5d, K6d) against the plain
# version: both sides apply the same mask and round at the same points as
# K5/K6 do; on an H100 (tests/port/kernel_l2_errors.py) these cases
# measured at most 1.0e-4 (bf16), 3.1e-5 (fp16) and 4.7e-7 (fp32) on the
# CUDA cores, and 1.1e-4 (bf16) and 6.0e-5 (fp16) on the tensor cores
DROPOUT_L2_TOL = L2_TOL
DROPOUT_SEEDS = [-123456789, 2 ** 31 - 1]
# relative L2 of K1's and K1d's output against the plain version. For bf16
# and fp16 K1 rounds P to the input type as exp(s - m_running) in one pass,
# where the plain version rounds the normalized P, so the two round at
# different scales; in fp32 K1 rounds P nowhere and the plain version
# rounds it to fp32. On an H100 (tests/port/kernel_l2_errors.py) the
# K1/K1d cases, the tensor-core multi-tile ones included, measured at most
# 3.0e-3 (bf16), 3.8e-4 (fp16) and 2.3e-7 (fp32)
K1_L2_TOL = {"bfloat16": 6e-3, "float16": 8e-4, "float32": 1e-6}
# K10's probabilities (at most 1) against the plain version: fp32 inside
# both, so the outputs round from values a few fp32 ulps apart: one ulp of
# the output type at 1 (bf16 2^-8, fp16 2^-11), fp32 1e-6
SOFTMAX_TOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11,
               "float32": 1e-6}
# relative L2 of K10's y and K11's dx against the plain versions; on an
# H100 (tests/port/kernel_l2_errors.py) these cases measured at most
# 7.9e-5 (bf16), 1.9e-5 (fp16) and 7.4e-8 (fp32), and the largest |y
# diff| 1.2e-4 (bf16), 3.1e-5 (fp16), 3.0e-8 (fp32)
SOFTMAX_L2_TOL = {"bfloat16": 5e-4, "float16": 1.5e-4, "float32": 5e-7}
# relative L2 of K2q's output against the plain version (fp32 inside both,
# the same dequantized products in another order); on an H100
# (tests/port/kernel_l2_errors.py) these cases measured at most 8.8e-9
# (bf16), 1.8e-5 (fp16) and 1.7e-7 (fp32) with the one-block-a-slot-head
# kernel; K2 (bf16/fp16/fp32 pages) is held to the same band
K2Q_L2_TOL = {"bfloat16": 1e-4, "float16": 1e-4, "float32": 1e-6}
# the attention kernels' head dims: 64 and 128 native, 32 / 80 / 96
# zero-padded to the next, 256 (K1 and, for bf16 and fp16, K5/K6 on the
# tensor cores; fp32 K5/K6 on the CUDA cores at every head dim)
ATTN_DIMS = [32, 64, 80, 96, 128, 256]
# decode's: the buckets 64 / 128 / 256 / 512 and the widths between
DECODE_DIMS = [32, 64, 80, 128, 256, 512]
# (b, np, sq, sk): sk 128, 1024 and 4096 take 16-byte vectors (the three
# register buckets), 200 and 3000 element loads
SOFTMAX_SHAPES = [(2, 3, 64, 128), (2, 2, 37, 200), (1, 3, 48, 1024),
                  (1, 1, 24, 3000), (1, 2, 8, 4096)]
SOFTMAX_CASES = ["causal", "mask_b1", "mask_bnp", "mask_pad", "none"]
# (n, V, h) of the LM-head cases: n leaves partial 32-, 64- and 128-row
# tiles; in bf16/fp16 the tensor-core K8/K9 take h % 64 == 0 up to 1024:
# h = 1024 leaves a partial 768-column tile (16-row streamed tiles), h =
# 128 and 448 leave warpgroups 64-column products, and h = 160 takes the
# general (wmma) form, of K7 too; V = 384, 640 and 50304 leave the last
# 256-wide tile of the tensor-core K7 half empty, V = 1280 whole
XENT_SHAPES = [(200, 384, 128), (1032, 1280, 256), (136, 1280, 1024),
               (200, 50304, 768), (72, 640, 448), (136, 384, 160)]
# (n, V, h, tp) of the vocabulary-shard cases: V = 50432 is GPT-2's
# vocabulary padded for tp = 2 (shards of 25216 = 128 x 197 rows)
XENT_SHARD_SHAPES = [(200, 768, 128, 2), (1032, 2560, 256, 4),
                     (200, 50432, 768, 2)]
# K7p's partials (max, sum of exponentials, target, logits sum) against
# the plain version, the largest |diff| over max(1, the largest |value|)
# of each, and the shards' losses and lse combined in torch against K7 on
# the whole table, as XENT_LOSS_TOL. The shards' dX, each rounded to the
# half type and then summed, against K8's one rounding on the whole table:
# a second rounding of every element, so its relative L2 band is wider
# than XENT_L2_TOL. On an H100 (tests/port/kernel_l2_errors.py) these
# cases measured at most 3.6e-6 for the partials (4.1e-6 with K7p on
# wgmma, the edge-label cases included), 2.1e-7 for the combined
# loss and lse, 3.9e-4 (bf16), 1.4e-4 (fp16) and 2.8e-6 (fp32) for K8 and
# K9 on a shard, and 3.4e-3 (bf16), 2.1e-3 (fp16) and 2.8e-6 (fp32) for
# the summed dX, with K8/K9 on wmma and again on wgmma
XENT_PARTIAL_TOL = 1e-5
XENT_SHARD_DX_L2_TOL = {"bfloat16": 8e-3, "float16": 5e-3, "float32": 1e-5}
# (b, np, sq, sk) of K10L/K11L: 4097, 8193, 24577 and 49153 take element
# loads, the others 16-byte vectors; K10L's bodies (softmax_cuda.long_plan):
# regs for bf16/fp16 to 8192 keys, smem to 49152 bf16/fp16 and 24576 fp32
# keys (fp32 from 4097), walk past them. They are held to K10/K11's bands;
# on an H100 (tests/port/kernel_l2_errors.py) these cases measured at most
# 2.0e-4 (bf16), 2.3e-5 (fp16) and 1.2e-7 (fp32) relative L2 for K10L, and
# 6.7e-6 for K11L
SOFTMAX_LONG_SHAPES = [(1, 2, 8, 4097), (2, 1, 12, 5000), (1, 2, 8, 8192),
                       (1, 1, 6, 8193), (1, 1, 6, 16384), (1, 1, 4, 24576),
                       (1, 1, 4, 24577), (1, 1, 3, 49152), (1, 1, 3, 49153),
                       (1, 1, 2, 100000)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", ATTN_DIMS)
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
    _close_l2(out, ref, dtype, K1_L2_TOL)
    if seg is not None and case != "segments":
        assert (out[:, :, 5] == 0).all(), "a fully masked row gives 0"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", DECODE_DIMS)
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


@pytest.mark.parametrize("quant", [False, True])
def test_decode_past_512_launches_k10_and_not_k2(dev, quant):
    """At head dim 576, past the decode kernels' 512, ``decode_attention``
    takes the scores route: K10 once (fp32 scores, a ``[b, 1, 1, S]``
    key-padding mask), K2 and K2q never; it agrees with the plain version,
    a slot of length 0 giving 0."""
    gen = torch.Generator(device=dev).manual_seed(12)
    d, ps, max_pages, h = 576, 16, 4, 2
    lengths = torch.tensor([0, 1, ps, 3 * ps + 5], dtype=torch.int32,
                           device=dev)
    b = lengths.numel()
    pages = 1 + b * max_pages
    q = _randn(gen, b, h, d, dtype=torch.bfloat16, dev=dev)
    pt = (1 + torch.arange(b * max_pages, dtype=torch.int32,
                           device=dev)).reshape(b, max_pages)
    scales = {}
    if quant:
        kp, ks, _ = _quant_pages(gen, h, pages, ps, d, dev)
        vp, vs, _ = _quant_pages(gen, h, pages, ps, d, dev)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = (_randn(gen, h, pages, ps, d, dtype=torch.bfloat16,
                         dev=dev) for _ in range(2))
    counted = (decode_attention_cuda.decode_attention,
               decode_attention_cuda.decode_attention_quant,
               softmax_cuda.softmax_fwd)
    before = [fn.launches for fn in counted]
    out = decode_attention.decode_attention(q, kp, vp, pt, lengths,
                                            sm_scale=d ** -0.5, **scales)
    assert [fn.launches - n for fn, n in zip(counted, before)] == [0, 0, 1]
    ref = decode_attention.decode_attention_reference(
        q, kp, vp, pt, lengths, d ** -0.5, scales.get("k_scale"),
        scales.get("v_scale"))
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    assert (out[0] == 0).all(), "an inactive slot gives 0"


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    # head_dim 32 launches (zero-padded to 64) and agrees; past 256 (the
    # prefill kernels) and 512 (decode) the wrappers refuse
    gen = torch.Generator(device=dev).manual_seed(6)
    q = _randn(gen, 1, 2, 8, 32, dtype=torch.bfloat16, dev=dev)
    before = attention_cuda.prefill_attention.launches
    out = attention_cuda.prefill_attention(q, q, q, causal=True,
                                           sm_scale=32 ** -0.5)
    assert attention_cuda.prefill_attention.launches == before + 1
    assert out.shape == q.shape
    ref = attention._dense_attention(q, q, q, True, 32 ** -0.5, None)
    torch.cuda.synchronize()
    _close_l2(out, ref, "bfloat16", K1_L2_TOL)
    wide = torch.zeros(1, 2, 8, 264, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_cuda.prefill_attention(wide, wide, wide, causal=True,
                                          sm_scale=1.0)
    wide_pages = torch.zeros(2, 4, 16, 520, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_cuda.decode_attention(
            torch.zeros(1, 2, 520, device=dev, dtype=torch.bfloat16),
            wide_pages, wide_pages,
            torch.zeros(1, 4, dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev), sm_scale=1.0)
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


def _close_scaled(out, ref, rel):
    """max |out - ref| within ``rel`` of ref's largest magnitude."""
    scale = max(ref.float().abs().max().item(), 1.0)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * scale, (err, rel * scale)


def _close_l2(out, ref, dtype, tol=L2_TOL):
    """||out - ref|| / ||ref|| within ``tol[dtype]``: an error the size
    of the typical element fails here even where the largest element
    sets a wide outlier band."""
    out, ref = out.float(), ref.float()
    err = ((out - ref).norm() / ref.norm().clamp(min=1e-30)).item()
    assert err <= tol[dtype], (err, tol[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hidden", [64, 768, 1024, 4096, 8192, 100, 12288,
                                    12800, 6, 12, 36, 200])
@pytest.mark.parametrize("rows", [1, 37, 1000, 8193])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_kernels_match_plain(dev, dtype, hidden, rows, affine):
    """Every body and vector width of ``layer_norm_cuda.plan``: the rows
    body at 64-1024 (16-byte vectors), 200 (bf16/fp16 16-byte, fp32 in
    lanes of 16), 100, 36 and 12 (8-byte vectors; 12 one lane a row) and
    6 (4-byte vectors); the team body at 4096 and 8192 (and fp32 at 768
    and 1024); the wide body at 12288 and 12800; 8193 rows walk past the
    persistent grids."""
    torch_dtype, tol = DTYPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn(rows, hidden, generator=gen, device=dev) * 3 + 1).to(
        torch_dtype)
    dy = _randn(gen, rows, hidden, dtype=torch_dtype, dev=dev)
    w = b = None
    if affine:
        w = torch.randn(hidden, generator=gen, device=dev)
        b = torch.randn(hidden, generator=gen, device=dev)
    before = (layer_norm_cuda.layer_norm_fwd.launches,
              layer_norm_cuda.layer_norm_bwd.launches)
    y, mean, rstd = layer_norm_cuda.layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = layer_norm_cuda.layer_norm_bwd(x, w, mean, rstd, dy)
    assert (layer_norm_cuda.layer_norm_fwd.launches,
            layer_norm_cuda.layer_norm_bwd.launches) == (before[0] + 1,
                                                         before[1] + 1)
    ry, rmean, rrstd = layer_norm.layer_norm_fwd(x, w, b, 1e-5)
    rdx, rdw, rdb = layer_norm.layer_norm_bwd(x, w, rmean, rrstd, dy)
    torch.cuda.synchronize()
    for t in (y, dx, mean, rstd, dw, db):
        assert torch.isfinite(t.float()).all()
    assert dw.shape == db.shape == (hidden,)
    _close_scaled(y, ry, tol)
    _close_scaled(dx, rdx, tol)
    _close_l2(y, ry, dtype)
    _close_l2(dx, rdx, dtype)
    _close_scaled(mean, rmean, 1e-4)
    _close_scaled(rstd, rrstd, 1e-4)
    _close_scaled(dw, rdw, 1e-4)
    _close_scaled(db, rdb, 1e-4)


@pytest.mark.parametrize("hidden", [768, 100, 12800, 2560])
def test_layer_norm_backward_is_deterministic(dev, hidden):
    """Two K4 runs give the same bits on every body: rows (768, 100),
    wide (12800) and team (2560)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _randn(gen, 8192, hidden, dtype=torch.bfloat16, dev=dev)
    dy = _randn(gen, 8192, hidden, dtype=torch.bfloat16, dev=dev)
    w = torch.randn(hidden, generator=gen, device=dev)
    _, mean, rstd = layer_norm_cuda.layer_norm_fwd(x, w, None, 1e-5)
    first = layer_norm_cuda.layer_norm_bwd(x, w, mean, rstd, dy)
    again = layer_norm_cuda.layer_norm_bwd(x, w, mean, rstd, dy)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_layer_norm_autograd_runs_the_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _randn(gen, 64, 768, dtype=torch.bfloat16, dev=dev).requires_grad_()
    w = torch.ones(768, device=dev, requires_grad=True)
    b = torch.zeros(768, device=dev, requires_grad=True)
    before = (layer_norm_cuda.layer_norm_fwd.launches,
              layer_norm_cuda.layer_norm_bwd.launches)
    y = layer_norm.layer_norm(x, w, b)
    y.float().square().sum().backward()
    assert (layer_norm_cuda.layer_norm_fwd.launches,
            layer_norm_cuda.layer_norm_bwd.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


def test_fused_layer_norm_over_two_axes_runs_the_kernels(dev):
    """``FusedLayerNorm((64, 200))`` normalizes rows of 12800 (the
    row-per-block body past its registers) through K3/K4 and agrees with
    the plain versions, gradients included."""
    from apex_tpu_torch.normalization import FusedLayerNorm

    gen = torch.Generator(device=dev).manual_seed(7)
    x = (torch.randn(6, 64, 200, generator=gen, device=dev) * 2 + 1).to(
        torch.bfloat16)
    dy = _randn(gen, 6, 64, 200, dtype=torch.bfloat16, dev=dev)
    mod = FusedLayerNorm((64, 200), device=dev)
    with torch.no_grad():
        mod.weight.copy_(torch.randn(64, 200, generator=gen, device=dev))
        mod.bias.copy_(torch.randn(64, 200, generator=gen, device=dev))
    xg = x.clone().requires_grad_()
    before = (layer_norm_cuda.layer_norm_fwd.launches,
              layer_norm_cuda.layer_norm_bwd.launches)
    y = mod(xg)
    y.backward(dy)
    assert (layer_norm_cuda.layer_norm_fwd.launches,
            layer_norm_cuda.layer_norm_bwd.launches) == (before[0] + 1,
                                                         before[1] + 1)
    w, b = mod.weight.reshape(-1), mod.bias.reshape(-1)
    ry, rmean, rrstd = layer_norm.layer_norm_fwd(x.reshape(6, -1), w, b,
                                                 1e-5)
    rdx, rdw, rdb = layer_norm.layer_norm_bwd(x.reshape(6, -1), w, rmean,
                                              rrstd, dy.reshape(6, -1))
    torch.cuda.synchronize()
    _close_l2(y.reshape(6, -1), ry, "bfloat16")
    _close_l2(xg.grad.reshape(6, -1), rdx, "bfloat16")
    _close_scaled(mod.weight.grad.reshape(-1), rdw, 1e-4)
    _close_scaled(mod.bias.grad.reshape(-1), rdb, 1e-4)


def _attn_case(dev, dtype, d, case, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h = 2, 3
    sq, sk = (100, 100) if case != "cross" else (70, 133)
    q = _randn(gen, b, h, sq, d, dtype=dtype, dev=dev)
    k, v = (_randn(gen, b, h, sk, d, dtype=dtype, dev=dev) for _ in range(2))
    do = _randn(gen, b, h, sq, d, dtype=dtype, dev=dev)
    causal = case in ("causal", "segments")
    seg = None
    if case == "segments":
        s = torch.zeros(b, sq, dtype=torch.int32)
        s[:, :37], s[:, 37:81] = 1, 2
        seg = (s.to(dev), s.to(dev))
    elif case in ("masked_row", "cross"):
        sq_ids = torch.ones(b, sq, dtype=torch.int32)
        sq_ids[:, sq // 2:] = 2
        sq_ids[:, 5] = 9
        kv_ids = torch.ones(b, sk, dtype=torch.int32)
        kv_ids[:, sk // 2:] = 2
        seg = (sq_ids.to(dev), kv_ids.to(dev))
    return q, k, v, do, causal, seg


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", ATTN_DIMS)
@pytest.mark.parametrize("case", ["causal", "segments", "masked_row",
                                  "cross"])
def test_attention_bwd_kernels_match_plain(dev, dtype, d, case):
    torch_dtype, tol = DTYPES[dtype]
    q, k, v, do, causal, seg = _attn_case(dev, torch_dtype, d, case)
    scale = d ** -0.5
    o = attention_cuda.prefill_attention(q, k, v, causal=causal,
                                         sm_scale=scale, segment_ids=seg)
    before = (attention_bwd_cuda.attention_bwd_dq.launches,
              attention_bwd_cuda.attention_bwd_dkv.launches)
    dq, dk, dv = attention_bwd_cuda.attention_bwd(
        q, k, v, o, do, causal=causal, sm_scale=scale, segment_ids=seg)
    assert (attention_bwd_cuda.attention_bwd_dq.launches,
            attention_bwd_cuda.attention_bwd_dkv.launches) == (
                before[0] + 1, before[1] + 1)
    rdq, rdk, rdv = attention._attention_bwd_split(q, k, v, o, do, causal,
                                                   scale, seg)
    torch.cuda.synchronize()
    for out, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert out.dtype == ref.dtype == torch_dtype
        assert torch.isfinite(out.float()).all()
        _close_scaled(out, ref, tol)
        _close_l2(out, ref, dtype)
    if case in ("masked_row", "cross"):
        assert (dq[:, :, 5] == 0).all(), "a fully masked row has no dq"


# (sq, sk) of the tensor-core cases: several 64-row tiles with ragged ends,
# a cross shape whose ragged edges differ, and exact tiles
TC_SHAPES = [(300, 300), (200, 333), (256, 256)]


def _tc_case(dev, dtype, d, sq, sk, case, seed=17):
    """Causal inputs over several tiles; "segments" adds three segments
    in proportion to each length and a padded tail (id 0) on the query
    side, "dropout" a dropout seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h = 2, 2
    q, do = (_randn(gen, b, h, sq, d, dtype=dtype, dev=dev) for _ in range(2))
    k, v = (_randn(gen, b, h, sk, d, dtype=dtype, dev=dev) for _ in range(2))
    seg = sd = None
    if case == "segments":
        ids = [(torch.arange(n) * 3 // n + 1).to(torch.int32)
               .expand(b, n).contiguous() for n in (sq, sk)]
        ids[0][:, sq - 9:] = 0
        seg = (ids[0].to(dev), ids[1].to(dev))
    if case == "dropout":
        sd = torch.tensor([-987654321], dtype=torch.int32, device=dev)
    return q, k, v, do, seg, sd


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=[f"{a}x{b}" for a, b in TC_SHAPES])
@pytest.mark.parametrize("case", ["causal", "segments", "dropout"])
def test_attention_bwd_tensor_core_tiles_match_plain(dev, dtype, d, shape,
                                                     case):
    """K5/K6 (K5d/K6d for "dropout") over several tiles, ragged and
    exact, against the plain split backward."""
    torch_dtype, tol = DTYPES[dtype]
    sq, sk = shape
    q, k, v, do, seg, sd = _tc_case(dev, torch_dtype, d, sq, sk, case)
    scale, p = d ** -0.5, (0.1 if case == "dropout" else 0.0)
    o = attention._dense_attention(q, k, v, True, scale, seg, p, sd)
    if p:
        got = attention_bwd_cuda.attention_bwd_dropout(
            q, k, v, o, do, causal=True, sm_scale=scale, dropout_p=p,
            dropout_seed=sd, segment_ids=seg)
    else:
        got = attention_bwd_cuda.attention_bwd(
            q, k, v, o, do, causal=True, sm_scale=scale, segment_ids=seg)
    ref = attention._attention_bwd_split(q, k, v, o, do, True, scale, seg, p,
                                         sd)
    torch.cuda.synchronize()
    for out, r in zip(got, ref):
        assert out.dtype == torch_dtype
        assert torch.isfinite(out.float()).all()
        _close_scaled(out, r, tol)
        _close_l2(out, r, dtype)
    if case == "segments":
        assert (got[0][:, :, sq - 9:] == 0).all(), "padded rows have no dq"


def _k1_tc_case(dev, dtype, d, sq, sk, case):
    """``_tc_case``'s inputs for K1: "cross" takes the causal case's
    inputs without the causal mask."""
    q, k, v, _, seg, sd = _tc_case(dev, dtype, d, sq, sk,
                                   "causal" if case == "cross" else case)
    return q, k, v, case != "cross", seg, sd


def _k1(q, k, v, causal, scale, seg, sd, p=0.1):
    """K1, or K1d where a dropout seed is given."""
    if sd is None:
        return attention_cuda.prefill_attention(q, k, v, causal=causal,
                                                sm_scale=scale,
                                                segment_ids=seg)
    return attention_cuda.prefill_attention_dropout(
        q, k, v, causal=causal, sm_scale=scale, dropout_p=p,
        dropout_seed=sd, segment_ids=seg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=[f"{a}x{b}" for a, b in TC_SHAPES])
@pytest.mark.parametrize("case", ["causal", "segments", "dropout", "cross"])
def test_prefill_tensor_core_tiles_match_plain(dev, dtype, d, shape, case):
    """K1 (K1d for "dropout") over several tiles, ragged and exact, causal
    or not ("cross"), against the plain forward; the padded query rows of
    "segments" see no key of theirs and give exact zeros."""
    torch_dtype, tol = DTYPES[dtype]
    sq, sk = shape
    q, k, v, causal, seg, sd = _k1_tc_case(dev, torch_dtype, d, sq, sk, case)
    scale = d ** -0.5
    o = _k1(q, k, v, causal, scale, seg, sd)
    ref = attention._dense_attention(q, k, v, causal, scale, seg,
                                     0.1 if sd is not None else 0.0, sd)
    torch.cuda.synchronize()
    assert o.dtype == torch_dtype
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=0)
    _close_l2(o, ref, dtype, K1_L2_TOL)
    if case == "segments":
        assert (o[:, :, sq - 9:] == 0).all(), "a fully masked row gives 0"


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("dropout", [False, True])
def test_prefill_is_bitwise_repeatable(dev, dtype, dropout):
    """Each block owns its output rows (no atomics): two runs of K1, or of
    K1d, on the same inputs give the same bits."""
    q, k, v, _, _, sd = _k1_tc_case(dev, DTYPES[dtype][0], 64, 300, 300,
                                    "dropout")
    sd = sd if dropout else None
    first = _k1(q, k, v, True, 0.125, None, sd)
    again = _k1(q, k, v, True, 0.125, None, sd)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_prefill_runs_tensor_cores_for_half_types_only(dev):
    """bf16 and fp16 launch the tensor-core body (``prefill_attention_tc``),
    fp32 the CUDA-core one (``prefill_attention_simt``): the kernel names
    the profiler records, with and without dropout."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v, _, _, sd = _k1_tc_case(dev, dtype, 64, 128, 128, "dropout")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _k1(q, k, v, True, 0.125, None, None)
            _k1(q, k, v, True, 0.125, None, sd)
            torch.cuda.synchronize()
        names[dtype] = [e.key for e in prof.key_averages()
                        if "prefill_attention_" in e.key]
    for dtype in (torch.bfloat16, torch.float16):
        assert len(names[dtype]) == 2, names[dtype]
        assert all("prefill_attention_tc" in n for n in names[dtype])
    assert len(names[torch.float32]) == 2, names[torch.float32]
    assert all("prefill_attention_simt" in n for n in names[torch.float32])


def test_prefill_refuses_unaligned_rows(dev):
    flat = torch.zeros(1 * 2 * 8 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(1, 2, 8, 64)
    good = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_cuda.prefill_attention(q, good, good, causal=True,
                                         sm_scale=1.0)
    with pytest.raises(ValueError, match="16-byte"):
        attention_cuda.prefill_attention_dropout(
            good, good, q, causal=True, sm_scale=1.0, dropout_p=0.1,
            dropout_seed=torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("dropout", [False, True])
def test_attention_bwd_is_bitwise_repeatable(dev, dtype, dropout):
    """Each block owns its output rows (no atomics): two runs of K5/K6, or
    of K5d/K6d, on the same inputs give the same bits."""
    q, k, v, do, _, sd = _tc_case(dev, DTYPES[dtype][0], 64, 300, 300,
                                  "dropout")
    kw = dict(causal=True, sm_scale=0.125)
    if dropout:
        kw.update(dropout_p=0.1, dropout_seed=sd)
        run = attention_bwd_cuda.attention_bwd_dropout
    else:
        run = attention_bwd_cuda.attention_bwd
    o = attention._dense_attention(q, k, v, True, 0.125, None)
    first, again = run(q, k, v, o, do, **kw), run(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_attention_bwd_runs_tensor_cores_for_half_types_only(dev):
    """bf16 and fp16 launch the tensor-core kernels (``*_tc``), fp32 the
    CUDA-core ones (``*_simt``): the kernel names the profiler records."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v, do, _, _ = _tc_case(dev, dtype, 64, 128, 128, "causal")
        o = attention._dense_attention(q, k, v, True, 0.125, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            attention_bwd_cuda.attention_bwd(q, k, v, o, do, causal=True,
                                             sm_scale=0.125)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.key for e in prof.key_averages()
                                if "attention_bwd_" in e.key)
    for dtype in (torch.bfloat16, torch.float16):
        assert "attention_bwd_dq_tc" in names[dtype], names[dtype]
        assert "attention_bwd_dkv_tc" in names[dtype], names[dtype]
        assert "simt" not in names[dtype], names[dtype]
    assert "attention_bwd_dq_simt" in names[torch.float32]
    assert "attention_bwd_dkv_simt" in names[torch.float32]
    assert "_tc" not in names[torch.float32], names[torch.float32]


def test_attention_bwd_refuses_unaligned_rows(dev):
    flat = torch.zeros(1 * 2 * 8 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(1, 2, 8, 64)
    good = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd_cuda.attention_bwd(q, good, good, good, good,
                                         causal=True, sm_scale=1.0)


@pytest.mark.parametrize("d", [64, 80, 256])
def test_attention_autograd_runs_k1_k5_k6(dev, d):
    """fused_attention with gradients: one K1, K5 and K6 launch each, and
    at a padded head dim (80) or the two-warpgroup backward's (256) the
    gradients of the true head dim, within band of the plain backward."""
    q, k, v, do, causal, seg = _attn_case(dev, torch.bfloat16, d, "causal")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = lambda: (attention_cuda.prefill_attention.launches,  # noqa: E731
                      attention_bwd_cuda.attention_bwd_dq.launches,
                      attention_bwd_cuda.attention_bwd_dkv.launches)
    before = counts()
    o = attention.fused_attention(*leaves, causal=True)
    o.backward(do)
    assert counts() == tuple(c + 1 for c in before)
    assert o.shape == q.shape
    assert leaves[0].grad.shape == q.shape
    assert leaves[1].grad.dtype == torch.bfloat16
    ro = attention._dense_attention(q, k, v, True, d ** -0.5, None)
    # the backward reads the forward's own o, as the plain one does here
    ref = attention._attention_bwd_split(q, k, v, o.detach(), do, True,
                                         d ** -0.5, None)
    torch.cuda.synchronize()
    _close_l2(o, ro, "bfloat16", K1_L2_TOL)
    for leaf, r in zip(leaves, ref):
        _close_scaled(leaf.grad, r, DTYPES["bfloat16"][1])
        _close_l2(leaf.grad, r, "bfloat16")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("dropout", [False, True])
def test_attention_bwd_at_256_is_bitwise_repeatable(dev, dtype, dropout):
    """At head dim 256 too each block owns its output rows: two runs of
    K5/K6, or of K5d/K6d, over ragged tiles give the same bits."""
    q, k, v, do, seg, sd = _tc_case(dev, DTYPES[dtype][0], 256, 200, 333,
                                    "dropout" if dropout else "segments")
    kw = dict(causal=True, sm_scale=0.0625, segment_ids=seg)
    if dropout:
        kw.update(dropout_p=0.1, dropout_seed=sd)
        run = attention_bwd_cuda.attention_bwd_dropout
    else:
        run = attention_bwd_cuda.attention_bwd
    o = attention._dense_attention(q, k, v, True, 0.0625, seg)
    first, again = run(q, k, v, o, do, **kw), run(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_attention_bwd_at_256_runs_the_tensor_core_bodies(dev):
    """bf16 and fp16 at head dim 256 launch K5's tensor-core body and
    K6's two-warpgroup one (``attention_bwd_dkv_tc2``); fp32 the CUDA-core
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v, do, _, _ = _tc_case(dev, dtype, 256, 128, 128, "causal")
        o = attention._dense_attention(q, k, v, True, 0.0625, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            attention_bwd_cuda.attention_bwd(q, k, v, o, do, causal=True,
                                             sm_scale=0.0625)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.key for e in prof.key_averages()
                                if "attention_bwd_" in e.key)
    for dtype in (torch.bfloat16, torch.float16):
        assert "attention_bwd_dq_tc" in names[dtype], names[dtype]
        assert "attention_bwd_dkv_tc2" in names[dtype], names[dtype]
        assert "simt" not in names[dtype], names[dtype]
    assert "attention_bwd_dq_simt" in names[torch.float32]
    assert "attention_bwd_dkv_simt" in names[torch.float32]


@pytest.mark.parametrize("case", ["causal", "segments"])
def test_scores_route_runs_k10_k11_past_256(dev, case):
    """fused_attention at head dim 320 with gradients takes the scores
    route: K10 and K11 launch once each, no attention kernel; the output
    and the gradients within band of autograd through the plain dense
    attention."""
    gen = torch.Generator(device=dev).manual_seed(320)
    b, h, s, d = 2, 3, 200, 320
    q, k, v, do = (_randn(gen, b, h, s, d, dtype=torch.bfloat16, dev=dev)
                   for _ in range(4))
    seg = None
    if case == "segments":
        ids = (torch.arange(s) * 3 // s + 1).to(torch.int32).expand(b, s)
        q_ids = ids.clone()
        q_ids[:, s - 9:] = 0                 # a padded tail: no key of its own
        seg = (q_ids.contiguous().to(dev), ids.contiguous().to(dev))
    counted = (attention_cuda.prefill_attention,
               attention_bwd_cuda.attention_bwd_dq,
               attention_bwd_cuda.attention_bwd_dkv,
               softmax_cuda.softmax_fwd, softmax_cuda.softmax_bwd)
    before = [fn.launches for fn in counted]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention.fused_attention(*leaves, causal=True, segment_ids=seg)
    o.backward(do)
    assert [fn.launches - n for fn, n in zip(counted, before)] \
        == [0, 0, 0, 1, 1]
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    ro = attention._dense_attention(*refs, True, d ** -0.5, seg)
    ro.backward(do)
    torch.cuda.synchronize()
    _close_l2(o, ro, "bfloat16")
    for leaf, ref in zip(leaves, refs):
        _close_scaled(leaf.grad, ref.grad, DTYPES["bfloat16"][1])
        _close_l2(leaf.grad, ref.grad, "bfloat16")
    if seg is not None:
        assert (o[:, :, s - 9:] == 0).all(), "a fully masked row gives 0"


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    # widths 12 (not a multiple of 8) and 8200 (past the team body) launch
    # and agree; a row of vectors off its 16-byte boundary is refused
    gen = torch.Generator(device=dev).manual_seed(8)
    for hidden in (12, 8200):
        x = _randn(gen, 4, hidden, dtype=torch.bfloat16, dev=dev)
        before = layer_norm_cuda.layer_norm_fwd.launches
        y, _, _ = layer_norm_cuda.layer_norm_fwd(x, None, None, 1e-5)
        assert layer_norm_cuda.layer_norm_fwd.launches == before + 1
        ry, _, _ = layer_norm.layer_norm_fwd(x, None, None, 1e-5)
        torch.cuda.synchronize()
        _close_l2(y, ry, "bfloat16")
    flat = torch.zeros(4 * 64 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        layer_norm_cuda.layer_norm_fwd(flat[1:].view(4, 64), None, None,
                                       1e-5)
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do"):
        attention_bwd_cuda.attention_bwd(q, q, q, q, q[:, :1], causal=True,
                                         sm_scale=1.0)


def _xent_case(dev, dtype, n, V, h, seed=7):
    """x like a layer-normed hidden, E like the model's init, seeded
    labels (one outside the vocabulary) and a non-uniform cotangent."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, n, h, dtype=dtype, dev=dev)
    e = (torch.randn(V, h, generator=gen, device=dev) * 0.02).to(dtype)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[3] = V + 5                       # no target: contributes nothing
    dl = (torch.rand(n, generator=gen, device=dev) + 0.5) / n
    return x, e, labels, dl


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", XENT_SHAPES,
                         ids=[f"{n}x{V}x{h}" for n, V, h in XENT_SHAPES])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xent_kernels_match_plain(dev, dtype, shape, smoothing):
    torch_dtype, tol = DTYPES[dtype]
    x, e, labels, dl = _xent_case(dev, torch_dtype, *shape)
    counts = lambda: (xent_cuda.xent_fwd.launches,  # noqa: E731
                      xent_cuda.xent_bwd_dx.launches,
                      xent_cuda.xent_bwd_de.launches)
    before = counts()
    loss, lse = xent_cuda.xent_fwd(x, e, labels, smoothing)
    dx = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl, smoothing)
    de = xent_cuda.xent_bwd_de(x, e, labels, lse, dl, smoothing)
    assert counts() == tuple(c + 1 for c in before)
    rloss, rlse = xent.linear_cross_entropy_fwd(x, e, labels, smoothing)
    rdx = xent.linear_cross_entropy_dx(x, e, labels, rlse, dl, smoothing)
    rde = xent.linear_cross_entropy_de(x, e, labels, rlse, dl, smoothing)
    torch.cuda.synchronize()
    assert loss.dtype == lse.dtype == torch.float32
    assert dx.dtype == de.dtype == torch_dtype
    for out, ref in ((loss, rloss), (lse, rlse)):
        _close_scaled(out, ref, XENT_LOSS_TOL)
    for out, ref in ((dx, rdx), (de, rde)):
        assert torch.isfinite(out.float()).all()
        _close_scaled(out, ref, tol)
        _close_l2(out, ref, dtype, XENT_L2_TOL)


# (n, V, h) of the label-edge cases: V = 384 and 50304 leave the last
# 256-wide tile of the tensor-core K7 half empty (its E rows past V load as
# zeros); n = 200 leaves a partial 128-row block; h = 160 takes the wmma
# form in bf16/fp16, and every fp32 case the CUDA-core form
XENT_EDGE_SHAPES = [(200, 384, 128), (200, 50304, 768), (200, 384, 160)]


def _edge_labels(labels, V):
    """Labels at 0 and V - 1, in the range of the zero-filled columns past
    V, past them, and negative (the last three hit no column)."""
    labels = labels.clone()
    labels[:5] = torch.tensor([0, V - 1, V + 5, V + 300, -3],
                              dtype=torch.int32)
    return labels


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", XENT_EDGE_SHAPES,
                         ids=[f"{n}x{V}x{h}" for n, V, h in XENT_EDGE_SHAPES])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xent_fwd_labels_at_the_edges(dev, dtype, shape, smoothing):
    """K7 and K7p (the whole table as one shard) against their plain
    versions with labels at the vocabulary's edges, and two runs of each
    equal bit for bit."""
    x, e, labels, _ = _xent_case(dev, DTYPES[dtype][0], *shape)
    labels = _edge_labels(labels, shape[1])
    loss, lse = xent_cuda.xent_fwd(x, e, labels, smoothing)
    part = xent_cuda.xent_fwd_partials(x, e, labels, smoothing)
    rloss, rlse = xent.linear_cross_entropy_fwd(x, e, labels, smoothing)
    rpart = torch.stack(xent.linear_cross_entropy_partials(x, e, labels,
                                                           smoothing))
    for out, ref in ((loss, rloss), (lse, rlse)):
        _close_scaled(out, ref, XENT_LOSS_TOL)
    # no target for the last three rows: loss = lse (- eps u / V)
    assert (part[2, 2:5] == 0).all() and (rpart[2, 2:5] == 0).all()
    err = ((part - rpart).abs().amax(dim=1)
           / rpart.abs().amax(dim=1).clamp(min=1.0)).max().item()
    assert err <= XENT_PARTIAL_TOL, err
    again = xent_cuda.xent_fwd(x, e, labels, smoothing)
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(part, xent_cuda.xent_fwd_partials(x, e, labels,
                                                         smoothing))


def test_xent_de_is_deterministic(dev):
    x, e, labels, dl = _xent_case(dev, torch.bfloat16, 2048, 50304, 768)
    _, lse = xent_cuda.xent_fwd(x, e, labels)
    first = xent_cuda.xent_bwd_de(x, e, labels, lse, dl)
    again = xent_cuda.xent_bwd_de(x, e, labels, lse, dl)
    assert torch.equal(first, again)


def test_xent_dx_is_deterministic(dev):
    x, e, labels, dl = _xent_case(dev, torch.bfloat16, 2048, 50304, 768)
    _, lse = xent_cuda.xent_fwd(x, e, labels)
    first = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl)
    again = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl)
    assert torch.equal(first, again)


def test_xent_autograd_runs_k7_k8_k9(dev):
    x, e, labels, dl = _xent_case(dev, torch.bfloat16, 200, 1280, 256)
    x, e = x.requires_grad_(), e.requires_grad_()
    counts = lambda: (xent_cuda.xent_fwd.launches,  # noqa: E731
                      xent_cuda.xent_bwd_dx.launches,
                      xent_cuda.xent_bwd_de.launches)
    before = counts()
    loss = xent.linear_cross_entropy(x, e, labels.long())
    loss.backward(dl)
    assert counts() == tuple(c + 1 for c in before)
    assert x.grad.dtype == e.grad.dtype == torch.bfloat16
    assert loss.shape == (200,) and loss.dtype == torch.float32


def test_xent_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, e, labels, _ = _xent_case(dev, torch.bfloat16, 16, 384, 128)
    with pytest.raises(ValueError, match="CUDA"):
        xent_cuda.xent_fwd(x.cpu(), e.cpu(), labels.cpu())
    with pytest.raises(ValueError, match="dtype"):
        xent_cuda.xent_fwd(x.double(), e.double(), labels)
    with pytest.raises(ValueError, match="shape"):
        xent_cuda.xent_fwd(x, e[:300], labels)      # V not a multiple of 128
    with pytest.raises(ValueError, match="shape"):
        xent_cuda.xent_fwd(x[:, :48].contiguous(), e[:, :48].contiguous(),
                           labels)                   # h not a multiple of 32
    with pytest.raises(ValueError, match="labels"):
        xent_cuda.xent_fwd(x, e, labels.long())
    with pytest.raises(ValueError, match="embedding"):
        xent_cuda.xent_fwd(x, e.float(), labels)
    _, lse = xent_cuda.xent_fwd(x, e, labels)
    with pytest.raises(ValueError, match="dl"):
        xent_cuda.xent_bwd_de(x, e, labels, lse, lse[:8].contiguous())


def _xent_shard_errors(dev, dtype, n, V, h, tp, eps):
    """K7p, K8 and K9 on each of ``tp`` vocabulary shards of one case:
    the errors of each kernel against its plain version, and of the
    shards combined against K7-K9 on the whole table. Returns a dict of
    the largest errors; also used by ``kernel_l2_errors.py``."""
    x, e, labels, dl = _xent_case(dev, dtype, n, V, h)
    vs = V // tp
    loss, lse = xent_cuda.xent_fwd(x, e, labels, eps)
    dx = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl, eps)
    de = xent_cuda.xent_bwd_de(x, e, labels, lse, dl, eps)
    shards = [(e[r * vs:(r + 1) * vs], (labels - r * vs).to(torch.int32))
              for r in range(tp)]
    err = {"partials": 0.0, "dx_shard_l2": 0.0, "de_shard_l2": 0.0}
    parts = []
    for es, local in shards:
        p = xent_cuda.xent_fwd_partials(x, es, local, eps)
        ref = torch.stack(xent.linear_cross_entropy_partials(x, es, local,
                                                             eps))
        assert torch.isfinite(p).all()
        err["partials"] = max(err["partials"], (
            (p - ref).abs().amax(dim=1)
            / ref.abs().amax(dim=1).clamp(min=1.0)).max().item())
        parts.append(p)
    # the cross-rank combine, in rank order
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    total = sum(p[1] * torch.exp(p[0] - m) for p in parts)
    t = sum(p[2] for p in parts)
    slse = m + torch.log(total)
    sloss = slse - t
    if eps:
        sloss = slse - (1.0 - eps) * t - eps * sum(p[3] for p in parts) / V
    scale = max(loss.abs().max().item(), 1.0)
    err["combined_loss"] = max((sloss - loss).abs().max().item(),
                               (slse - lse).abs().max().item()) / scale
    dx_sum, de_parts = None, []
    for es, local in shards:
        dxs = xent_cuda.xent_bwd_dx(x, es, local, slse, dl, eps, v_total=V)
        des = xent_cuda.xent_bwd_de(x, es, local, slse, dl, eps, v_total=V)
        rdx = xent.linear_cross_entropy_dx(x, es, local, slse, dl, eps, V)
        rde = xent.linear_cross_entropy_de(x, es, local, slse, dl, eps, V)
        err["dx_shard_l2"] = max(err["dx_shard_l2"], _l2(dxs, rdx))
        err["de_shard_l2"] = max(err["de_shard_l2"], _l2(des, rde))
        dx_sum = dxs if dx_sum is None else dx_sum + dxs   # in x's dtype
        de_parts.append(des)
    err["dx_sum_l2"] = _l2(dx_sum, dx)
    err["de_cat_l2"] = _l2(torch.cat(de_parts), de)
    return err


def _l2(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    return ((out - ref).norm() / ref.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", XENT_SHARD_SHAPES,
                         ids=[f"{n}x{V}x{h}_tp{tp}"
                              for n, V, h, tp in XENT_SHARD_SHAPES])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xent_shard_kernels_match_plain_and_the_whole_table(dev, dtype,
                                                            shape,
                                                            smoothing):
    before = xent_cuda.xent_fwd_partials.launches
    err = _xent_shard_errors(dev, DTYPES[dtype][0], *shape, smoothing)
    assert xent_cuda.xent_fwd_partials.launches == before + shape[3]
    assert err["partials"] <= XENT_PARTIAL_TOL, err
    assert err["combined_loss"] <= XENT_LOSS_TOL, err
    for k in ("dx_shard_l2", "de_shard_l2", "de_cat_l2"):
        assert err[k] <= XENT_L2_TOL[dtype], (k, err)
    assert err["dx_sum_l2"] <= XENT_SHARD_DX_L2_TOL[dtype], err


def test_xent_bwd_refuses_a_v_total_below_the_table(dev):
    x, e, labels, dl = _xent_case(dev, torch.bfloat16, 16, 384, 128)
    _, lse = xent_cuda.xent_fwd(x, e, labels)
    with pytest.raises(ValueError, match="v_total"):
        xent_cuda.xent_bwd_dx(x, e, labels, lse, dl, 0.1, v_total=256)
    with pytest.raises(ValueError, match="labels"):
        xent_cuda.xent_fwd_partials(x, e, labels.long())


def _drop_case(dev, dtype, d, case, seed):
    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, s = 2, 3, 200
    q, k, v, do = (_randn(gen, b, h, s, d, dtype=dtype, dev=dev)
                   for _ in range(4))
    seg = None
    if case == "segments":
        ids = torch.zeros(b, s, dtype=torch.int32)
        ids[:, :70], ids[:, 70:161] = 1, 2          # 161.. is padding (0)
        seg = (ids.to(dev), ids.to(dev))
    return q, k, v, do, seg, torch.tensor([seed], dtype=torch.int32,
                                          device=dev)


def _drop_counts():
    return (attention_cuda.prefill_attention_dropout.launches,
            attention_bwd_cuda.attention_bwd_dq_dropout.launches,
            attention_bwd_cuda.attention_bwd_dkv_dropout.launches)


@pytest.mark.parametrize("seed", DROPOUT_SEEDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("case", ["causal", "segments"])
def test_dropout_kernels_match_plain(dev, dtype, d, case, seed):
    torch_dtype, tol = DTYPES[dtype]
    q, k, v, do, seg, sd = _drop_case(dev, torch_dtype, d, case, seed)
    scale, p = d ** -0.5, 0.1
    kw = dict(causal=True, sm_scale=scale, dropout_p=p, dropout_seed=sd,
              segment_ids=seg)
    before = _drop_counts()
    o = attention_cuda.prefill_attention_dropout(q, k, v, **kw)
    dq, dk, dv = attention_bwd_cuda.attention_bwd_dropout(q, k, v, o, do,
                                                          **kw)
    assert _drop_counts() == tuple(c + 1 for c in before)
    ro = attention._dense_attention(q, k, v, True, scale, seg, p, sd)
    ref = attention._attention_bwd_split(q, k, v, o, do, True, scale, seg, p,
                                         sd)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    _close_l2(o, ro, dtype, K1_L2_TOL)
    for out, r in zip((dq, dk, dv), ref):
        assert out.dtype == r.dtype == torch_dtype
        assert torch.isfinite(out.float()).all()
        _close_scaled(out, r, tol)
        _close_l2(out, r, dtype, DROPOUT_L2_TOL)
    # dropout changed the function
    assert not torch.allclose(o.float(), attention._dense_attention(
        q, k, v, True, scale, seg).float(), atol=tol)


# BERT's padding dropout route: sq = sk = s with partial 64-row tiles (200,
# 333) and whole ones (512, BERT's length)
PAD_LENGTHS = [200, 333, 512]


def _pad_case(dev, dtype, s, seed, d=64):
    """BERT's padding route at length ``s``: q, k, v, dO ``[3, 2, s, d]``
    and the segment ids (valid 0, pad 1) of a row all valid, a row of one
    valid token and a row padded after ``s - 37``."""
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, do = (_randn(gen, 3, 2, s, d, dtype=dtype, dev=dev)
                   for _ in range(4))
    lengths = torch.tensor([s, 1, s - 37])
    ids = (torch.arange(s)[None] >= lengths[:, None]).to(torch.int32)
    ids = ids.to(dev).contiguous()
    return q, k, v, do, (ids, ids), torch.tensor([seed], dtype=torch.int32,
                                                 device=dev)


@pytest.mark.parametrize("seed", DROPOUT_SEEDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", PAD_LENGTHS)
def test_padding_dropout_kernels_match_plain(dev, dtype, s, seed):
    """K1d, K5d and K6d non-causal with padding segment ids (the route
    BERT trains on with dropout) against their plain versions: the
    all-valid row walks every key block, a valid query sees the valid
    keys and a pad query the pad keys."""
    torch_dtype, tol = DTYPES[dtype]
    q, k, v, do, seg, sd = _pad_case(dev, torch_dtype, s, seed)
    scale, p = 64 ** -0.5, 0.1
    kw = dict(causal=False, sm_scale=scale, dropout_p=p, dropout_seed=sd,
              segment_ids=seg)
    before = _drop_counts()
    o = attention_cuda.prefill_attention_dropout(q, k, v, **kw)
    dq, dk, dv = attention_bwd_cuda.attention_bwd_dropout(q, k, v, o, do,
                                                          **kw)
    assert _drop_counts() == tuple(c + 1 for c in before)
    ro = attention._dense_attention(q, k, v, False, scale, seg, p, sd)
    ref = attention._attention_bwd_split(q, k, v, o, do, False, scale, seg,
                                         p, sd)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    _close_l2(o, ro, dtype, K1_L2_TOL)
    for out, r in zip((dq, dk, dv), ref):
        assert out.dtype == r.dtype == torch_dtype
        assert torch.isfinite(out.float()).all()
        _close_scaled(out, r, tol)
        _close_l2(out, r, dtype, DROPOUT_L2_TOL)


def test_dropout_mask_is_recovered_exactly_from_k1d(dev):
    """q = k = 0 and V the identity: every score is 0, P = 1/128 on each
    row, and O[i, j] = mscale[i, j] / 128 exactly, so K1d's output gives
    back its mask, which must equal the plain mask in every element."""
    b, h, s, d = 2, 3, 1024, 128
    q = torch.zeros(b, h, s, d, device=dev)
    k = torch.zeros(b, h, d, d, device=dev)
    v = torch.eye(d, device=dev).expand(b, h, d, d).contiguous()
    for seed in (0, -1, -2 ** 31, 2 ** 31 - 1, 987654321):
        sd = torch.tensor([seed], dtype=torch.int32, device=dev)
        o = attention_cuda.prefill_attention_dropout(
            q, k, v, causal=False, sm_scale=0.125, dropout_p=0.1,
            dropout_seed=sd)
        want = attention.dropout_mscale(sd, b, h, s, d, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(o * d, want), seed


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dropout_mask_is_kept_exactly_where_half_k1d_keeps(dev, dtype):
    """The tensor-core K1d on the inputs above: O is a rounding of mscale /
    128 to the half type, so it is non-zero exactly where the plain mask
    keeps."""
    torch_dtype = DTYPES[dtype][0]
    b, h, s, d = 2, 3, 1024, 128
    q = torch.zeros(b, h, s, d, device=dev, dtype=torch_dtype)
    k = torch.zeros(b, h, d, d, device=dev, dtype=torch_dtype)
    v = torch.eye(d, device=dev, dtype=torch_dtype).expand(
        b, h, d, d).contiguous()
    for seed in (0, -1, -2 ** 31, 2 ** 31 - 1, 987654321):
        sd = torch.tensor([seed], dtype=torch.int32, device=dev)
        o = attention_cuda.prefill_attention_dropout(
            q, k, v, causal=False, sm_scale=0.125, dropout_p=0.1,
            dropout_seed=sd)
        want = attention.dropout_mscale(sd, b, h, s, d, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(o != 0, want != 0), seed


def test_dropout_backward_is_repeatable(dev):
    q, k, v, do, _, sd = _drop_case(dev, torch.bfloat16, 64, "causal", -5)
    kw = dict(causal=True, sm_scale=0.125, dropout_p=0.1, dropout_seed=sd)
    o = attention_cuda.prefill_attention_dropout(q, k, v, **kw)
    dq, m, l, dcol = attention_bwd_cuda.attention_bwd_dq_dropout(q, k, v, o,
                                                                 do, **kw)
    first = attention_bwd_cuda.attention_bwd_dkv_dropout(q, k, v, do, m, l,
                                                         dcol, **kw)
    again = attention_bwd_cuda.attention_bwd_dkv_dropout(q, k, v, do, m, l,
                                                         dcol, **kw)
    dq2 = attention_bwd_cuda.attention_bwd_dq_dropout(q, k, v, o, do, **kw)[0]
    for a, b in zip(first + (dq,), again + (dq2,)):
        assert torch.equal(a, b)


def test_dropout_autograd_runs_k1d_k5d_k6d(dev):
    q, k, v, do, _, sd = _drop_case(dev, torch.bfloat16, 64, "causal", 7)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    plain = (attention_cuda.prefill_attention.launches,
             attention_bwd_cuda.attention_bwd_dq.launches,
             attention_bwd_cuda.attention_bwd_dkv.launches)
    before = _drop_counts()
    o = attention.fused_attention(q, k, v, causal=True, dropout_p=0.1,
                                  dropout_seed=sd)
    o.backward(do)
    assert _drop_counts() == tuple(c + 1 for c in before)
    assert (attention_cuda.prefill_attention.launches,
            attention_bwd_cuda.attention_bwd_dq.launches,
            attention_bwd_cuda.attention_bwd_dkv.launches) == plain
    assert q.grad.dtype == torch.bfloat16


def test_dropout_wrappers_refuse_bad_seeds_and_rates(dev):
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    kw = dict(causal=True, sm_scale=1.0)
    good = torch.zeros(1, dtype=torch.int32, device=dev)
    for bad in (good.cpu(), good.long(), torch.zeros(1, 1, dtype=torch.int32,
                                                     device=dev)):
        with pytest.raises(ValueError, match="dropout_seed"):
            attention_cuda.prefill_attention_dropout(
                q, q, q, dropout_p=0.1, dropout_seed=bad, **kw)
    with pytest.raises(ValueError, match="dropout_p"):
        attention_cuda.prefill_attention_dropout(q, q, q, dropout_p=0.0,
                                                 dropout_seed=good, **kw)
    with pytest.raises(ValueError, match="dropout_p"):
        attention_bwd_cuda.attention_bwd_dropout(q, q, q, q, q, dropout_p=1.0,
                                                 dropout_seed=good, **kw)


def _quant_pages(gen, h, pages, ps, d, dev):
    """int8 codes and [h, pages] bf16 scales of random pages, quantized by
    the tier's own codec, and the fp32 pages they dequantize to."""
    raw = torch.randn(h, pages, ps, d, generator=gen, device=dev) * 2
    scale = (raw.abs().amax(dim=(-2, -1)) / kv_tier.QMAX).to(torch.bfloat16)
    codes = kv_tier.quantize(raw, scale)
    return codes, scale, kv_tier.dequantize(codes, scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", DECODE_DIMS)
@pytest.mark.parametrize("ps", [16, 128])
def test_int8_decode_kernel_matches_plain_and_reads_only_live_pages(
        dev, dtype, d, ps):
    torch_dtype, tol = DTYPES[dtype]
    tol = min(tol, 2e-2)
    gen = torch.Generator(device=dev).manual_seed(3)
    max_pages, h = 5, 4
    lengths_l = [0, 1, ps - 1, ps, ps + 1, max_pages * ps, 3 * ps + 2]
    b = len(lengths_l)
    pages = 2 + sum(-(-n // ps) for n in lengths_l)
    q = _randn(gen, b, h, d, dtype=torch_dtype, dev=dev)
    (k8, ks, kf), (v8, vs, vf) = (_quant_pages(gen, h, pages, ps, d, dev)
                                  for _ in range(2))
    pt = torch.zeros(b, max_pages, dtype=torch.int32)
    live = set()
    nxt = pages - 1
    for i, n in enumerate(lengths_l):
        for j in range(-(-n // ps)):
            pt[i, j] = nxt
            live.add(nxt)
            nxt -= 1
    pt = pt.to(dev)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    ref = decode_attention.decode_attention_reference(
        q, k8, v8, pt, lengths, d ** -0.5, ks, vs)
    # K2q over int8 pages equals K2 over the pages they dequantize to
    # (fp32 on both sides: the same products in another order)
    same = decode_attention_cuda.decode_attention(
        q.float(), kf, vf, pt, lengths, sm_scale=d ** -0.5)
    # poison the scales of every page no slot holds live rows in (null
    # page 0 too): the kernel must never read them
    for p in set(range(pages)) - live:
        ks[:, p] = float("nan")
        vs[:, p] = float("nan")
    before = (decode_attention_cuda.decode_attention_quant.launches,
              decode_attention_cuda.decode_attention.launches)
    out = decode_attention.decode_attention(q, k8, v8, pt, lengths,
                                            sm_scale=d ** -0.5, k_scale=ks,
                                            v_scale=vs)
    assert (decode_attention_cuda.decode_attention_quant.launches,
            decode_attention_cuda.decode_attention.launches) \
        == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    assert out.dtype == torch_dtype
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    _close_l2(out, ref, dtype, K2Q_L2_TOL)
    out32 = decode_attention_cuda.decode_attention_quant(
        q.float(), k8, v8, ks, vs, pt, lengths, sm_scale=d ** -0.5)
    torch.testing.assert_close(out32, same, atol=1e-5, rtol=0)
    assert (out[0] == 0).all(), "an inactive slot gives 0"


# (dtype, d, ps) of the split cases: bf16 at the serving page (one split
# a page), fp32 at d = 512 (16 keys a split: eight splits a page; K2q's
# int8 pages take 64), bf16 at d = 80 in 48-key pages, and fp16 at d = 20
# in 7-key pages, whose 280-byte (int8: 140) pages the threads copy
# element by element
SPLIT_CASES = [("bfloat16", 64, 128), ("float32", 512, 128),
               ("bfloat16", 80, 48), ("float16", 20, 7)]


def _split_case(dev, dtype, d, ps, quant, seed=21):
    """Lengths at every split boundary of the plan (sk - 1, sk, sk + 1,
    a page and a page's edges, the table's reach, past it), pages handed
    out in a random order, and out-of-range entries in the longest slot's
    table (one past P, one negative: both clamp)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_pages, h = 4, 3
    elem = 1 if quant else torch.empty((), dtype=dtype).element_size()
    _, sk, _ = decode_attention_cuda.plan(d, ps, max_pages, elem)
    lengths_l = sorted({0, 1, max(1, sk - 1), sk, sk + 1, ps - 1, ps, ps + 1,
                        2 * ps + sk, max_pages * ps, max_pages * ps + 50})
    b = len(lengths_l)
    pages = 4 + sum(min(max_pages, -(-n // ps)) for n in lengths_l)
    q = _randn(gen, b, h, d, dtype=dtype, dev=dev)
    if quant:
        (kp, ks, _), (vp, vs, _) = (_quant_pages(gen, h, pages, ps, d, dev)
                                    for _ in range(2))
        scales = (ks, vs)
    else:
        kp, vp = (_randn(gen, h, pages, ps, d, dtype=dtype, dev=dev)
                  for _ in range(2))
        scales = (None, None)
    perm = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    pt = torch.zeros(b, max_pages, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths_l):
        for j in range(min(max_pages, -(-n // ps))):
            pt[i, j] = int(perm[nxt])
            nxt += 1
    pt[-1, 1], pt[-1, 2] = pages + 7, -4
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    return q, kp, vp, scales, pt.to(dev), lengths, sk


@pytest.mark.parametrize("quant", [False, True], ids=["k2", "k2q"])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"{t}-d{d}-ps{p}" for t, d, p in SPLIT_CASES])
def test_decode_splits_at_their_boundaries(dev, case, quant):
    """K2/K2q against the plain version on the clamped table; three runs
    (the tickets reset by each) give the same bits."""
    dtype, d, ps = case
    torch_dtype, tol = DTYPES[dtype]
    tol = min(tol, 2e-2)
    q, kp, vp, (ks, vs), pt, lengths, sk = _split_case(dev, torch_dtype, d,
                                                       ps, quant)
    scale = d ** -0.5
    n_pages = kp.shape[1]
    ref = decode_attention.decode_attention_reference(
        q, kp, vp, pt.clamp(0, n_pages - 1), lengths, scale, ks, vs)

    def run():
        return decode_attention.decode_attention(q, kp, vp, pt, lengths,
                                                 sm_scale=scale, k_scale=ks,
                                                 v_scale=vs)

    counter = (decode_attention_cuda.decode_attention_quant if quant
               else decode_attention_cuda.decode_attention)
    before = counter.launches
    out, again, third = run(), run(), run()
    assert counter.launches == before + 3
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    _close_l2(out, ref, dtype, K2Q_L2_TOL)
    assert (out[0] == 0).all(), "an inactive slot gives 0"
    for other in (again, third):
        assert torch.equal(out, other)


@pytest.mark.parametrize("quant", [False, True], ids=["k2", "k2q"])
def test_decode_on_two_streams_at_once(dev, quant):
    """K2/K2q launched in turns on two streams that run side by side, each
    stream over its own inputs: every output equals the one a launch on
    the default stream gives, so the launches of one stream never take
    the other's tickets."""
    cases = [_split_case(dev, torch.bfloat16, 64, 128, quant, seed=s)
             for s in (31, 32)]

    def run(case):
        q, kp, vp, (ks, vs), pt, lengths, _ = case
        return decode_attention.decode_attention(q, kp, vp, pt, lengths,
                                                 sm_scale=0.125, k_scale=ks,
                                                 v_scale=vs)

    want = [run(c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in cases]
    outs = [[], []]
    for _ in range(20):
        for i, (c, st) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(st):
                outs[i].append(run(c))
    torch.cuda.synchronize()
    for i, c in enumerate(cases):
        q, kp, vp, (ks, vs), pt, lengths, _ = c
        ref = decode_attention.decode_attention_reference(
            q, kp, vp, pt.clamp(0, kp.shape[1] - 1), lengths, 0.125, ks, vs)
        torch.testing.assert_close(want[i].float(), ref.float(), atol=2e-2,
                                   rtol=0)
        for o in outs[i]:
            assert torch.equal(o, want[i])


def test_int8_decode_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 2, 64, device=dev, dtype=torch.bfloat16)
    pages = torch.zeros(2, 4, 16, 64, device=dev, dtype=torch.int8)
    sc = torch.zeros(2, 4, device=dev, dtype=torch.bfloat16)
    pt = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    ln = torch.ones(1, dtype=torch.int32, device=dev)
    call = decode_attention_cuda.decode_attention_quant
    with pytest.raises(ValueError, match="k_scale"):
        call(q, pages, pages, sc.float(), sc, pt, ln, sm_scale=1.0)
    with pytest.raises(ValueError, match="v_scale"):
        call(q, pages, pages, sc, sc[:, :3].contiguous(), pt, ln,
             sm_scale=1.0)
    with pytest.raises(ValueError, match="dtypes"):
        call(q, pages.to(torch.bfloat16), pages, sc, sc, pt, ln,
             sm_scale=1.0)
    with pytest.raises(ValueError, match="int8 pages without"):
        decode_attention.decode_attention(q, pages, pages, pt, ln)
    with pytest.raises(ValueError, match="pair"):
        decode_attention.decode_attention(q, pages, pages, pt, ln,
                                          k_scale=sc)


def _softmax_case(dev, dtype, shape, case, seed=13):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, np_, sq, sk = shape
    x = (torch.randn(b, np_, sq, sk, generator=gen, device=dev) * 3).to(
        dtype)
    g = _randn(gen, b, np_, sq, sk, dtype=dtype, dev=dev)
    mask = None
    if case == "mask_b1":
        mask = torch.rand(b, 1, sq, sk, generator=gen, device=dev) < 0.3
    elif case == "mask_bnp":
        mask = torch.rand(b, np_, sq, sk, generator=gen, device=dev) < 0.3
        mask[0, 0, 1] = True                      # a fully masked row
    elif case == "mask_pad":                      # key padding [b, 1, 1, sk]
        live = torch.tensor([max(1, sk - 37 * (i + 1)) for i in range(b)],
                            device=dev)
        mask = (torch.arange(sk, device=dev)[None, None, None, :]
                >= live[:, None, None, None])
    return x, g, mask, case == "causal"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SOFTMAX_SHAPES,
                         ids=["x".join(map(str, s)) for s in SOFTMAX_SHAPES])
@pytest.mark.parametrize("case", SOFTMAX_CASES)
def test_softmax_kernels_match_plain(dev, dtype, shape, case):
    torch_dtype, _ = DTYPES[dtype]
    x, g, mask, causal = _softmax_case(dev, torch_dtype, shape, case)
    scale = 0.37
    before = (softmax_cuda.softmax_fwd.launches,
              softmax_cuda.softmax_bwd.launches)
    y = softmax_cuda.softmax_fwd(x, mask, scale, causal)
    dx = softmax_cuda.softmax_bwd(y, g, scale)
    assert (softmax_cuda.softmax_fwd.launches,
            softmax_cuda.softmax_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    ry = softmax.scaled_masked_softmax_reference(x, mask, scale, causal)
    rdx = softmax.scaled_masked_softmax_backward_reference(y, g, scale)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == torch_dtype
    assert torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
    torch.testing.assert_close(y.float(), ry.float(),
                               atol=SOFTMAX_TOL[dtype], rtol=0)
    _close_l2(y, ry, dtype, SOFTMAX_L2_TOL)
    _close_scaled(dx, rdx, 10 * SOFTMAX_TOL[dtype])
    _close_l2(dx, rdx, dtype, SOFTMAX_L2_TOL)
    # masked positions are exactly 0, on both sides
    assert torch.equal(y == 0, ry == 0)
    if case == "mask_bnp":
        assert (y[0, 0, 1] == 0).all(), "a fully masked row gives 0"
    if causal:
        b, np_, sq, sk = shape
        above = (torch.arange(sk, device=dev)[None, :]
                 > torch.arange(sq, device=dev)[:, None])
        assert (y[..., above] == 0).all()


# BERT's padding masks: the extended [b, 1, s, s] mask of the scores path
# (a pad query's row fully masked) and a key-padding [b, 1, 1, s] mask with
# a batch row of no valid key (all its rows fully masked)
PAD_SOFTMAX_SHAPES = [(3, 2, 200, 200), (2, 4, 512, 512)]
PAD_SOFTMAX_CASES = ["extended", "key_padding"]


def _pad_softmax_case(dev, dtype, shape, case, seed=19):
    """x, g and the padding mask of rows of valid lengths (sk, 1, sk - 37
    for the extended mask; sk, 0, sk - 37 for the key padding)."""
    from apex_tpu_torch.transformer.testing import (
        bert_extended_attention_mask)

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, np_, sq, sk = shape
    x = (torch.randn(b, np_, sq, sk, generator=gen, device=dev) * 3).to(
        dtype)
    g = _randn(gen, b, np_, sq, sk, dtype=dtype, dev=dev)
    lengths = torch.tensor([sk, 1 if case == "extended" else 0,
                            sk - 37][:b], device=dev)
    valid = torch.arange(sk, device=dev)[None] < lengths[:, None]
    if case == "extended":
        mask = bert_extended_attention_mask(valid)
    else:
        mask = ~valid[:, None, None, :]
    return x, g, mask


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", PAD_SOFTMAX_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in PAD_SOFTMAX_SHAPES])
@pytest.mark.parametrize("case", PAD_SOFTMAX_CASES)
def test_softmax_kernels_match_plain_under_padding_masks(dev, dtype, shape,
                                                          case):
    """K10 in mask mode and K11 under BERT's padding masks against their
    plain versions; the fully masked rows are exact zeros."""
    torch_dtype, _ = DTYPES[dtype]
    x, g, mask = _pad_softmax_case(dev, torch_dtype, shape, case)
    scale = 24.0                      # BERT-large's last layer's coeff
    y = softmax_cuda.softmax_fwd(x, mask, scale, False)
    dx = softmax_cuda.softmax_bwd(y, g, scale)
    ry = softmax.scaled_masked_softmax_reference(x, mask, scale, False)
    rdx = softmax.scaled_masked_softmax_backward_reference(y, g, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
    torch.testing.assert_close(y.float(), ry.float(),
                               atol=SOFTMAX_TOL[dtype], rtol=0)
    _close_l2(y, ry, dtype, SOFTMAX_L2_TOL)
    _close_scaled(dx, rdx, 10 * SOFTMAX_TOL[dtype])
    _close_l2(dx, rdx, dtype, SOFTMAX_L2_TOL)
    assert torch.equal(y == 0, ry == 0)
    dead = mask.all(dim=-1).expand(y.shape[:-1])
    assert dead.any() and (y[dead] == 0).all() and (dx[dead] == 0).all()


def test_bert_model_takes_its_routes_on_the_card(dev):
    """A bf16 BertModel on the card: deterministic, the scores path (K10
    and K11 once a layer, no attention kernel); training with dropout at s
    = 128, the segment-id route (K1d, K5d, K6d once a layer, no K10)."""
    from apex_tpu_torch.transformer.testing import BertModel

    cfg = TransformerConfig(hidden_size=128, num_layers=2,
                            num_attention_heads=2, vocab_size=512,
                            max_position_embeddings=128, bf16=True)
    model = BertModel(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, 512, (2, 128), generator=gen, device=dev)
    mask = torch.ones(2, 128, dtype=torch.long, device=dev)
    mask[1, 40:] = 0
    counted = (softmax_cuda.softmax_fwd, softmax_cuda.softmax_bwd,
               attention_cuda.prefill_attention,
               attention_cuda.prefill_attention_dropout,
               attention_bwd_cuda.attention_bwd_dq_dropout,
               attention_bwd_cuda.attention_bwd_dkv_dropout)
    for drop, want in ((None, (2, 2, 0, 0, 0, 0)),
                       (gen, (0, 0, 0, 2, 2, 2))):
        before = [f.launches for f in counted]
        kw = {} if drop is None else dict(deterministic=False,
                                          dropout_generator=drop)
        loss, binary = model(ids, mask, None, ids, **kw)
        loss.mean().backward()
        torch.cuda.synchronize()
        assert torch.isfinite(loss).all() and binary.shape == (2, 2)
        assert tuple(f.launches - b for f, b in zip(counted, before)) == want
        model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["causal", "mask_b1"])
def test_softmax_fwd_is_deterministic(dev, dtype, case):
    x, _, mask, causal = _softmax_case(dev, DTYPES[dtype][0],
                                       (2, 3, 64, 1024), case)
    first = softmax_cuda.softmax_fwd(x, mask, 0.37, causal)
    assert torch.equal(first, softmax_cuda.softmax_fwd(x, mask, 0.37,
                                                       causal))


def test_softmax_autograd_runs_k10_k11_and_refuses_bad_input(dev):
    x, g, mask, _ = _softmax_case(dev, torch.bfloat16, (2, 4, 64, 128),
                                  "mask_b1")
    x.requires_grad_()
    before = (softmax_cuda.softmax_fwd.launches,
              softmax_cuda.softmax_bwd.launches)
    y = softmax.scaled_masked_softmax(x, mask, 2.0)
    y.backward(g)
    assert (softmax_cuda.softmax_fwd.launches,
            softmax_cuda.softmax_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sk"):   # K10L takes these
        softmax_cuda.softmax_fwd(torch.zeros(1, 1, 2, 4097, device=dev),
                                 None, 1.0, False)
    with pytest.raises(ValueError, match="mask"):
        softmax_cuda.softmax_fwd(x.detach(), mask.float(), 1.0, False)
    with pytest.raises(ValueError, match="g must"):
        softmax_cuda.softmax_bwd(y.detach(), g.float(), 1.0)


def test_fused_scale_mask_softmax_launches_k10_or_raises_on_the_card(dev):
    """With the kernel chosen, the module never takes the plain function
    on a CUDA tensor: a key-padding mask launches K10 (and K11 in the
    backward); rows over 4096 keys through the generic variant launch
    K10L; a mask that does not broadcast raises; ``use_pallas=False``
    takes the plain function."""
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import (
        FusedScaleMaskSoftmax, GenericFusedScaleMaskSoftmax)

    x, g, mask, _ = _softmax_case(dev, torch.bfloat16, (2, 4, 64, 128),
                                  "mask_pad")
    fused = FusedScaleMaskSoftmax(False, True, AttnMaskType.padding, True,
                                  None, True, 2.0)
    assert fused.is_kernel_available(mask, *x.shape)
    x.requires_grad_()
    before = (softmax_cuda.softmax_fwd.launches,
              softmax_cuda.softmax_bwd.launches)
    y = fused(x, mask)
    y.backward(g)
    assert (softmax_cuda.softmax_fwd.launches,
            softmax_cuda.softmax_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    ref = softmax.scaled_masked_softmax_reference(x.detach(), mask, 2.0,
                                                  False)
    torch.testing.assert_close(y.detach().float(), ref.float(),
                               atol=SOFTMAX_TOL["bfloat16"], rtol=0)
    with pytest.raises(ValueError, match="broadcast"):
        fused(x.detach(), mask[:, :, :, :64].contiguous())
    generic = GenericFusedScaleMaskSoftmax(False, True, None, True, None)
    long = torch.zeros(1, 1, 4, 4097, device=dev, dtype=torch.bfloat16)
    assert generic.is_kernel_available(None, *long.shape)
    before = (softmax_cuda.softmax_fwd.launches,
              softmax_cuda.softmax_fwd_long.launches)
    y = generic(long, None)
    assert (softmax_cuda.softmax_fwd.launches,
            softmax_cuda.softmax_fwd_long.launches) \
        == (before[0], before[1] + 1)
    torch.testing.assert_close(y.float(), torch.full_like(y, 1 / 4097).float(),
                               atol=2.0 ** -16, rtol=0)
    before = softmax_cuda.softmax_fwd.launches
    plain = GenericFusedScaleMaskSoftmax(False, True, None, True, None,
                                         use_pallas=False)(long, None)
    assert softmax_cuda.softmax_fwd.launches == before
    torch.testing.assert_close(plain.float(),
                               torch.full_like(plain, 1 / 4097).float(),
                               atol=2.0 ** -16, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SOFTMAX_LONG_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in SOFTMAX_LONG_SHAPES])
@pytest.mark.parametrize("case", SOFTMAX_CASES)
def test_long_softmax_kernels_match_plain(dev, dtype, shape, case):
    """K10L and K11L against the plain versions, held as K10 and K11 are
    (the same bands: fp32 inside both, the outputs rounded once)."""
    torch_dtype, _ = DTYPES[dtype]
    x, g, mask, causal = _softmax_case(dev, torch_dtype, shape, case)
    scale = 0.37
    before = (softmax_cuda.softmax_fwd_long.launches,
              softmax_cuda.softmax_bwd_long.launches)
    y = softmax_cuda.softmax_fwd_long(x, mask, scale, causal)
    dx = softmax_cuda.softmax_bwd_long(y, g, scale)
    assert (softmax_cuda.softmax_fwd_long.launches,
            softmax_cuda.softmax_bwd_long.launches) \
        == (before[0] + 1, before[1] + 1)
    ry = softmax.scaled_masked_softmax_reference(x, mask, scale, causal)
    rdx = softmax.scaled_masked_softmax_backward_reference(y, g, scale)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == torch_dtype
    assert torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
    torch.testing.assert_close(y.float(), ry.float(),
                               atol=SOFTMAX_TOL[dtype], rtol=0)
    _close_l2(y, ry, dtype, SOFTMAX_L2_TOL)
    _close_scaled(dx, rdx, 10 * SOFTMAX_TOL[dtype])
    _close_l2(dx, rdx, dtype, SOFTMAX_L2_TOL)
    assert torch.equal(y == 0, ry == 0)
    if case == "mask_bnp":
        assert (y[0, 0, 1] == 0).all(), "a fully masked row gives 0"


def test_long_softmax_autograd_runs_k10l_k11l(dev):
    """Over 4096 keys the autograd call launches K10L and K11L and
    neither K10 nor K11; the two runs of K11L give the same bits."""
    x, g, mask, _ = _softmax_case(dev, torch.bfloat16, (2, 2, 8, 5000),
                                  "mask_b1")
    x.requires_grad_()
    counts = lambda: (softmax_cuda.softmax_fwd.launches,  # noqa: E731
                      softmax_cuda.softmax_bwd.launches,
                      softmax_cuda.softmax_fwd_long.launches,
                      softmax_cuda.softmax_bwd_long.launches)
    before = counts()
    y = softmax.scaled_masked_softmax(x, mask, 2.0)
    y.backward(g)
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    again = softmax_cuda.softmax_bwd_long(y.detach(), g, 2.0)
    assert torch.equal(softmax_cuda.softmax_bwd_long(y.detach(), g, 2.0),
                       again)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SOFTMAX_LONG_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in SOFTMAX_LONG_SHAPES])
def test_long_softmax_fwd_is_deterministic_on_every_body(dev, dtype, shape):
    """Two K10L runs give the same bits, causal and masked, on each body."""
    torch_dtype, _ = DTYPES[dtype]
    for case in ("causal", "mask_bnp"):
        x, _, mask, causal = _softmax_case(dev, torch_dtype, shape, case)
        a = softmax_cuda.softmax_fwd_long(x, mask, 0.37, causal)
        assert torch.equal(softmax_cuda.softmax_fwd_long(x, mask, 0.37,
                                                         causal), a)


def test_long_softmax_refuses_a_plan_its_c_entry_does_not_take(dev,
                                                              monkeypatch):
    """K10L's C entry refuses the register body for fp32 (it has no
    fp32 instantiation) and a register plan too small for the row; the
    wrapper raises and counts no launch."""
    x = torch.randn(1, 1, 4, 5000, device=dev)
    for dtype, plan in ((torch.float32, ("regs", 256, 0)),
                        (torch.bfloat16, ("regs", 32, 0))):
        monkeypatch.setattr(softmax_cuda, "long_plan",
                            lambda *_, p=plan: softmax_cuda.LongPlan(*p))
        before = softmax_cuda.softmax_fwd_long.launches
        with pytest.raises(RuntimeError):
            softmax_cuda.softmax_fwd_long(x.to(dtype), None, 1.0, False)
        assert softmax_cuda.softmax_fwd_long.launches == before


def _graph_tokens(dev, cfg, params, kv_quant, sampled, k, graph):
    """The tokens of a seeded trace through an engine with prefill_requests
    = 1: each prompt alone at offset 0 of its packed batch, so its bf16
    prefill does not depend on the schedule (K = 4 admits at other ticks
    than K = 1, and K1 rounds a packed request's attention by its offset
    in the batch)."""
    eng = ServingEngine(cfg, params, device=dev, kv_quant=kv_quant,
                        sampling=sampled, decode_k=k, cuda_graph=graph,
                        num_slots=4, page_size=16, num_pages=40, max_seq=64,
                        prefill_len=64, prefill_requests=1)
    assert (eng._graph is not None) == graph
    reqs, _ = synthetic_trace(seed=2, n_requests=10, vocab=cfg.vocab_size,
                              prompt_lo=3, prompt_hi=30, new_lo=2,
                              new_hi=20)
    for r in reqs:
        if sampled and r.rid % 2:
            r.sampling = sampling.SamplingParams(
                temperature=0.8, top_k=50, top_p=0.95, seed=r.rid)
    done = eng.run_trace(reqs)
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_graphed_decode_gives_the_eager_tokens(dev, kv_quant, sampled):
    """The decode program captured once and replayed every round gives
    the eager program's tokens bit for bit, at K = 1 and K = 4."""
    cfg = TransformerConfig(
        hidden_size=64, num_layers=2, num_attention_heads=4, vocab_size=128,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False,
        bf16=True)
    params = init_gpt_params(cfg, 0, dev)
    eager = _graph_tokens(dev, cfg, params, kv_quant, sampled, 1, False)
    assert _graph_tokens(dev, cfg, params, kv_quant, sampled, 1,
                         True) == eager
    assert _graph_tokens(dev, cfg, params, kv_quant, sampled, 4,
                         True) == eager


def test_engine_captures_its_decode_program_on_the_card(dev):
    cfg = TransformerConfig(
        hidden_size=64, num_layers=1, num_attention_heads=4, vocab_size=64,
        max_position_embeddings=32, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False,
        bf16=True)
    kw = dict(num_slots=2, page_size=16, num_pages=8, max_seq=32,
              prefill_len=32, device=dev)
    # the decode wrapper is called at the warm-up and at the capture, and
    # by no replay: the replayed kernels are seen only in a device trace
    before = decode_attention_cuda.decode_attention.launches
    eng = ServingEngine(cfg, **kw)
    assert eng._graph is not None
    assert decode_attention_cuda.decode_attention.launches == before + 2
    reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=5)
            for i in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_trace(reqs)
        torch.cuda.synchronize()
    assert decode_attention_cuda.decode_attention.launches == before + 2
    ran = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "decode_attention_split" in e.key)
    assert eng.decode_steps and ran == eng.decode_steps
    assert ServingEngine(cfg, cuda_graph=False, **kw)._graph is None


# ------------------------- serving's generation and page-pressure layers
# a small engine with one prompt a prefill call (a layer-on and a layer-off
# run then prefill each prompt alike whatever ticks they admit it at)
LAYER_SIZES = dict(num_slots=4, page_size=16, num_pages=40, max_seq=64,
                   prefill_len=64, prefill_requests=1)


def _layer_cfg(bf16):
    return TransformerConfig(
        hidden_size=64, num_layers=2, num_attention_heads=4, vocab_size=128,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False,
        bf16=bf16)


def _layer_serve(dev, cfg, params, spec, **kw):
    """The tokens, prompts and engine of a seeded trace through a graphed
    engine at ``LAYER_SIZES`` updated by ``kw``; K1's wrapper must count
    (prefill calls + verify calls) x layers over the run."""
    eng = ServingEngine(cfg, params, device=dev, **dict(LAYER_SIZES, **kw))
    assert eng._graph is not None
    reqs, _ = synthetic_trace(**spec)
    before = attention_cuda.prefill_attention.launches
    done = eng.run_trace(reqs)
    assert attention_cuda.prefill_attention.launches - before == (
        eng.prefill_batches + eng.verify_calls) * cfg.num_layers
    assert eng._cache_ptrs() == eng._graph_cache
    return ({r.rid: list(r.out_tokens) for r in done},
            {r.rid: r.prompt for r in reqs}, eng)


def _rule2(*args, **kw):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    return chip_smoke.rule2_check(*args, **kw)


SPEC_TRACE = dict(seed=2, n_requests=10, vocab=128, prompt_lo=3,
                  prompt_hi=30, new_lo=8, new_hi=30)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_spec_decode_on_the_card_holds_under_rule_2(dev, bf16):
    """spec_decode=2 against off: verify calls launch K1, and the tokens
    are equal up to each request's first divergence, which must be a
    near-tie of the layer-off logits (chip_smoke.rule2_check)."""
    from apex_tpu_torch.serving import model as smodel

    cfg = _layer_cfg(bf16)
    params = init_gpt_params(cfg, 0, dev)
    off, prompts, _ = _layer_serve(dev, cfg, params, SPEC_TRACE)
    on, _, eng = _layer_serve(dev, cfg, params, SPEC_TRACE, spec_decode=2)
    assert eng.verify_calls > 0 and eng.spec_stats.accepted > 0
    held = _rule2(cfg, smodel.cast_params(params, cfg), dev, prompts, off,
                  on, sizes=LAYER_SIZES)
    assert held["equal_requests"] + held["divergences"] == len(off)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_prefix_cache_on_the_card_keeps_its_pages(dev, kv_quant):
    """A shared 24-token system prompt (a full page and a copy-on-write
    tail): hits, the graph's cache pointers unchanged after the copies,
    the chain pages' bytes unchanged since they registered, and the
    tokens under rule 2 against the cache off."""
    from apex_tpu_torch.serving import model as smodel

    cfg = _layer_cfg(True)
    params = init_gpt_params(cfg, 0, dev)
    spec = dict(SPEC_TRACE, prompt_hi=20, new_hi=16,
                system_prompt=list(range(3, 27)))
    off, prompts, _ = _layer_serve(dev, cfg, params, spec,
                                   kv_quant=kv_quant)
    on, _, eng = _layer_serve(dev, cfg, params, spec, kv_quant=kv_quant,
                              prefix_cache=True)
    assert eng.generation_stats()["prefix_hit_rate"] > 0
    eng.prefix.check_invariants()
    _rule2(cfg, smodel.cast_params(params, cfg), dev, prompts, off, on,
           kv_quant=kv_quant, sizes=LAYER_SIZES)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_swap_restore_on_the_card_gives_the_unpreempted_tokens(
        dev, monkeypatch, kv_quant):
    """KV-pressure preemption with the host swap tier over 6 pages of 16:
    the banked pages (pinned host memory, every leaf) come back byte for
    byte into the captured cache, so every stream's tokens are the
    unpreempted run's bit for bit; recompute replays launch K1."""
    cfg = _layer_cfg(True)
    params = init_gpt_params(cfg, 0, dev)
    spec = dict(SPEC_TRACE, prompt_hi=20, new_lo=20, new_hi=40)
    banked = []
    bank = ServingEngine._swap_out_slot

    def swap_out(self, slot):
        handle = bank(self, slot)
        if handle is not None:
            banked.append(handle)
        return handle

    monkeypatch.setattr(ServingEngine, "_swap_out_slot", swap_out)
    want, _, _ = _layer_serve(dev, cfg, params, spec, kv_quant=kv_quant)
    got, _, eng = _layer_serve(dev, cfg, params, spec, kv_quant=kv_quant,
                               preempt=True, kv_swap=True, num_pages=6)
    assert eng.resilience.preempted > 0 and eng.kv_stats.swap_ins > 0
    assert banked and all(t.is_pinned() for h in banked
                          for t in h.leaves.values())
    assert all(sorted(h.leaves) == sorted(eng.cache) for h in banked)
    assert eng.kv_stats.swapped_pages_live == 0
    assert got == want
    _, _, eng = _layer_serve(dev, cfg, params, spec, kv_quant=kv_quant,
                             preempt=True, num_pages=6)
    assert eng.resilience.preempted > 0


# --------------------- round recovery, the overlapped round, the router

def _with_plan(monkeypatch, plan):
    import json

    from apex_tpu_torch.resilience import faults

    faults._cache["fired"] = {}
    monkeypatch.setenv("APEX_FAULT_PLAN", json.dumps(plan))


@pytest.mark.parametrize("kind", ["raise", "hang"])
def test_recovered_engine_on_the_card_gives_the_fault_free_tokens(
        dev, monkeypatch, kind):
    """fp32, graphed: a decode round that raises or hangs past the
    watchdog is recovered (the cache zeroed in place, the graph's
    pointers kept), the requeued streams replay through K1, and every
    stream's tokens are the fault-free run's bit for bit; the abandoned
    closure, woken, launches nothing."""
    cfg = _layer_cfg(False)
    params = init_gpt_params(cfg, 0, dev)
    want, _, _ = _layer_serve(dev, cfg, params, SPEC_TRACE)
    eng = ServingEngine(cfg, params, device=dev, recover=True,
                        round_retry_wait_s=0, dispatch_timeout_s=60,
                        **LAYER_SIZES)
    reqs, _ = synthetic_trace(**SPEC_TRACE)
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    while len(eng.scheduler.completed) < len(reqs):
        if eng.tick == 3:
            ptrs = eng._cache_ptrs()
            fault = {"site": "serve_decode", "kind": kind,
                     "match_ctx": {"tick": 3}}
            if kind == "hang":
                fault["seconds"] = 6.0
                eng.dispatch_timeout_s = 1.0
            _with_plan(monkeypatch, [fault])
        due = [r for r in pending if r.arrival <= eng.tick]
        pending = pending[len(due):]
        eng.step(arrivals=due)
    monkeypatch.delenv("APEX_FAULT_PLAN")
    assert eng.resilience.degraded_rounds == 1
    assert eng.resilience.last_verdict == ("wedged" if kind == "hang"
                                           else "degraded_relay")
    assert eng._cache_ptrs() == ptrs == eng._graph_cache
    assert {r.rid: list(r.out_tokens) for r in reqs} == want
    assert eng.events.validate_order() == []
    launched = eng.dispatches
    for w in eng.abandoned_workers:
        w.join(timeout=30)
    assert eng.stale_dispatches == (1 if kind == "hang" else 0)
    assert eng.dispatches == launched


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_overlapped_round_on_the_card_gives_the_serial_tokens(dev, kv_quant):
    """bf16, graphed K = 1: the overlapped round's tokens, admissions and
    finish ticks are the serial round's bit for bit (only the host
    schedule moves)."""
    cfg = _layer_cfg(True)
    params = init_gpt_params(cfg, 0, dev)
    runs = []
    for overlap in (False, True):
        eng = ServingEngine(cfg, params, device=dev, overlap=overlap,
                            kv_quant=kv_quant, **LAYER_SIZES)
        assert eng.overlap == overlap and eng._graph is not None
        reqs, _ = synthetic_trace(**SPEC_TRACE)
        eng.run_trace(reqs)
        assert eng._pending is None
        runs.append({r.rid: (list(r.out_tokens), r.admitted_tick,
                             r.finished_tick) for r in reqs})
    assert runs[0] == runs[1]


def test_drained_replica_late_round_launches_nothing(dev, monkeypatch):
    """A replica round wedged past the router's watchdog: the replica is
    drained and its requests replay on the survivor; the wedged round,
    woken, finds the engine's epoch moved and steps nothing (no
    dispatch, no admission)."""
    from apex_tpu_torch.serving import Router

    cfg = _layer_cfg(False)
    params = init_gpt_params(cfg, 0, dev)
    want, _, _ = _layer_serve(dev, cfg, params, SPEC_TRACE)
    engines = [ServingEngine(cfg, params, device=dev, **LAYER_SIZES)
               for _ in range(2)]
    rt = Router(engines, breaker_failures=1, probe_wait_rounds=10 ** 6)
    reqs, _ = synthetic_trace(**SPEC_TRACE)
    for r in reqs:
        assert rt.submit(r) is None
    for _ in range(3):
        rt.step()
    _with_plan(monkeypatch, [{"site": "router_wedge", "kind": "hang",
                              "seconds": 6.0,
                              "match_ctx": {"tick": rt.tick,
                                            "replica": "r1"}}])
    rt.step_timeout_s = 1.0
    while not all(r.done() for r in reqs):
        rt.step()
    monkeypatch.delenv("APEX_FAULT_PLAN")
    late = engines[1]
    launched = late.dispatches
    for w in rt.abandoned_workers:
        w.join(timeout=30)
    assert rt.replicas[1].state == "dead" and late.stale_steps == 1
    assert late.dispatches == launched and late.epoch == 1
    assert not late.scheduler.active_indices() and not late.scheduler.queue
    assert {r.rid: list(r.out_tokens) for r in reqs} == want


def test_launch_hung_on_the_card_recovers_to_the_fault_free_tokens(
        dev, monkeypatch):
    """fp32, graphed: the second prefill hangs inside its launch, holding
    the engine lock, until the watchdog times it out; the launch then
    ends, recovery takes the lock and zeroes the cache in place behind it,
    and every stream's tokens are the fault-free run's bit for bit."""
    import itertools
    import threading

    from apex_tpu_torch.serving import model as smodel
    from apex_tpu_torch.serving import resilience as serve_res

    cfg = _layer_cfg(False)
    params = init_gpt_params(cfg, 0, dev)
    want, _, _ = _layer_serve(dev, cfg, params, SPEC_TRACE)
    eng = ServingEngine(cfg, params, device=dev, recover=True,
                        round_retry_wait_s=0, dispatch_timeout_s=60,
                        **LAYER_SIZES)
    ptrs = eng._cache_ptrs()
    gate = threading.Event()
    real, calls = smodel.prefill, itertools.count()

    def prefill(*args, **kwargs):
        if next(calls) == 1:
            gate.wait(60)
        return real(*args, **kwargs)

    run = eng._watchdog.run

    def watched(fn, timeout_s, phase):
        try:
            return run(fn, timeout_s, phase)
        except serve_res.DispatchFailure:
            gate.set()
            raise

    monkeypatch.setattr(smodel, "prefill", prefill)
    monkeypatch.setattr(eng._watchdog, "run", watched)
    eng.dispatch_timeout_s = 5.0
    reqs, _ = synthetic_trace(**SPEC_TRACE)
    try:
        eng.run_trace(reqs)
    finally:
        gate.set()
    for w in eng.abandoned_workers:
        w.join(timeout=30)
    assert len(eng.abandoned_workers) == 1
    assert (eng.resilience.degraded_rounds, eng.resilience.last_verdict,
            eng.epoch) == (1, "wedged", 1)
    assert eng._cache_ptrs() == ptrs == eng._graph_cache
    assert {r.rid: list(r.out_tokens) for r in reqs} == want


def test_replica_wedged_in_its_decode_fetch_on_the_card_writes_nothing(
        dev, monkeypatch):
    """fp32, graphed: a replica's round blocks in the fetch of its decode
    tokens past the router's watchdog; the replica is drained and its
    streams replay on the survivor. Woken, the round takes the graph's
    tokens and drops them (the epoch moved): every stream is a single
    engine's, bit for bit."""
    import threading

    from apex_tpu_torch.serving import Router

    cfg = _layer_cfg(False)
    params = init_gpt_params(cfg, 0, dev)
    want, _, _ = _layer_serve(dev, cfg, params, SPEC_TRACE)
    engines = [ServingEngine(cfg, params, device=dev, **LAYER_SIZES)
               for _ in range(2)]
    rt = Router(engines, breaker_failures=1, probe_wait_rounds=10 ** 6)
    late = engines[1]
    gate, entered = threading.Event(), threading.Event()
    fetch = late._fetch_tokens

    def wedged(toks):
        if late.tick == 3 and not entered.is_set():
            entered.set()
            gate.wait(60)
        return fetch(toks)

    monkeypatch.setattr(late, "_fetch_tokens", wedged)
    reqs, _ = synthetic_trace(**SPEC_TRACE)
    for r in reqs:
        assert rt.submit(r) is None
    try:
        while not all(r.done() for r in reqs):
            if rt.tick == 3:
                rt.step_timeout_s = 1.0
            if rt.replicas[1].state == "dead" and not gate.is_set():
                gate.set()
                rt.abandoned_workers[0].join(timeout=30)
            rt.step()
    finally:
        gate.set()
    assert entered.is_set() and rt.replicas[1].state == "dead"
    assert (late.stale_steps, late.epoch, late.tick) == (1, 1, 3)
    assert not late.scheduler.active_indices() and not late.scheduler.queue
    assert {r.rid: list(r.out_tokens) for r in reqs} == want


# ------------------------------------------------------------ K12 - K15
# ragged leaves: a scalar tail (1, 3, 767), whole vectors (768), a ragged
# 4099, an empty and an all-zero leaf, two blocks (CHUNK + 5), a 2-D leaf
MT_SIZES = [1, 3, 767, 768, 4099, 0, 300, multi_tensor_cuda.CHUNK + 5,
            (33, 17)]
MT_ZERO = 6
MT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
# K13's norms (fp32 sums in another order than the plain version's
# torch.sum) and K15's parameters and moments after three steps (its
# per-tensor norms and global clip in that order, carried into each
# element by the trust ratio) against the plain versions, relative to each
# tensor's largest magnitude; on an H100 (tests/port/kernel_l2_errors.py)
# these cases measured at most 2.4e-7 (K13, bf16/fp16; fp32 1.2e-7; the
# max mode exactly) and 5.4e-7 (K15, against one_pass; two_pass 1.2e-7)
MT_NORM_TOL = 2e-6
MT_LAMB_TOL = 5e-6


def _mt_list(dev, dtype, seed, sizes=MT_SIZES, scale=1.0):
    """Seeded leaves of ``sizes`` in ``dtype``, the MT_ZERO-th all zero,
    and last a view 4 (fp32) or 2 bytes past its allocation's start."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [(torch.randn(n, generator=gen, device=dev) * scale).to(dtype)
           for n in sizes]
    out[MT_ZERO].zero_()
    out.append((torch.randn(1001, generator=gen, device=dev)
                * scale).to(dtype)[1:])
    assert out[-1].data_ptr() % 16 != 0
    return out


def _bits(t):
    t = t.contiguous()
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(_bits(a), _bits(b))


def test_foreach_div_by_a_device_scalar_divides(dev):
    """The plain Adam divides by its bias corrections, 0-d device tensors,
    with ``torch._foreach_div``; K14 divides with ``__fdiv_rn``. They agree
    only because PyTorch divides there too, and does not multiply by a
    reciprocal as it does for a host scalar."""
    x = torch.randn(1 << 20, device=dev)
    d = torch.tensor(0.7654321, device=dev)
    got = torch._foreach_div([x], d)[0]
    assert torch.equal(got, x / d)
    assert not torch.equal(got, x * (1.0 / d))


def test_multi_tensor_constants_match_the_source(dev):
    lib = _build.load("multi_tensor", multi_tensor_cuda._SIGNATURES)
    assert lib.multi_tensor_chunk() == multi_tensor_cuda.CHUNK
    for depth in (1, 2, 3, 4):
        assert lib.multi_tensor_capacity(depth) \
            == multi_tensor_cuda.capacity(depth)
    # K14 and K15: a whole list a launch (parameters past 4 KB, which need
    # CUDA 12.1 and a driver of R530 or later: 737 tensors, else 85)
    assert lib.multi_tensor_list_capacity() \
        == multi_tensor_cuda.list_capacity() == 737
    assert lib.multi_tensor_tile() == multi_tensor_cuda.TILE


@pytest.mark.parametrize("src,dst", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16"),
                                     ("float16", "float16")])
@pytest.mark.parametrize("check_input", [True, False])
@pytest.mark.parametrize("poison", [None, float("inf"), float("nan"), 3e38])
def test_scale_kernel_matches_plain_bit_for_bit(dev, src, dst, check_input,
                                               poison):
    srcs = _mt_list(dev, MT_DTYPES[src], 1, scale=1e4)
    if poison is not None and not (poison == 3e38 and src == "float16"):
        srcs[3][5] = poison
    inv = 1.0 / torch.tensor(2.0 ** -16, device=dev)   # a 0-d device scale
    dts = [MT_DTYPES[dst]] * len(srcs)
    before = multi_tensor_cuda.scale.launches
    outs, flag = multi_tensor_cuda.scale(srcs, dts, inv, check_input,
                                         torch.bool)
    assert multi_tensor_cuda.scale.launches == before + 1
    ref, rflag = multi_tensor.scale_reference(srcs, dts, inv, check_input,
                                              torch.bool)
    assert flag.item() == rflag.item()
    for i, (o, r) in enumerate(zip(outs, ref)):
        assert _same_bits(o, r), i
    outs, flag = multi_tensor_cuda.scale(srcs, dts, 0.5)   # a number
    ref, rflag = multi_tensor.scale_reference(srcs, dts, 0.5)
    assert flag.dtype == torch.int32 and flag.item() == rflag.item()
    assert all(_same_bits(o, r) for o, r in zip(outs, ref))


@pytest.mark.parametrize("dtype", sorted(MT_DTYPES))
def test_axpby_kernel_matches_plain_bit_for_bit(dev, dtype):
    xs = _mt_list(dev, MT_DTYPES[dtype], 2)
    ys = _mt_list(dev, MT_DTYPES[dtype], 3)
    ys[1][0] = float("inf")
    dts = [torch.float32] * len(xs)
    outs, flag = multi_tensor_cuda.axpby(xs, ys, dts, 0.37, -1.5)
    ref, rflag = multi_tensor.axpby_reference(xs, ys, dts, 0.37, -1.5)
    assert flag.item() == rflag.item() == 1
    assert all(_same_bits(o, r) for o, r in zip(outs, ref))


def _norm_errors(norms, ref):
    """The largest relative error of K13's per-tensor and total norms (and
    squares) against the plain version's."""
    err = 0.0
    for got, want in zip(norms, ref):
        scale = want.abs().max().clamp(min=1e-30)
        err = max(err, ((got - want).abs().max() / scale).item())
    return err


@pytest.mark.parametrize("dtype", sorted(MT_DTYPES))
@pytest.mark.parametrize("max_mode", [False, True])
@pytest.mark.parametrize("many", [False, True])
def test_l2norm_kernel_matches_plain_and_repeats(dev, dtype, max_mode,
                                                 many):
    """Within MT_NORM_TOL (max mode exactly: a max has no order), two runs
    the same bits; ``many``: more tensors than one launch's table."""
    sizes = MT_SIZES * (30 if many else 1)
    xs = _mt_list(dev, MT_DTYPES[dtype], 4, sizes)
    norms = multi_tensor_cuda.l2norm(xs, max_mode)
    again = multi_tensor_cuda.l2norm(xs, max_mode)
    ref = multi_tensor.l2norm_reference(xs, max_mode)
    if max_mode:
        assert all(torch.equal(a, b) for a, b in zip(norms, ref))
    else:
        assert _norm_errors(norms, ref) <= MT_NORM_TOL
    assert all(_same_bits(a, b) for a, b in zip(norms, again))
    assert norms.per_tensor[MT_ZERO].item() == 0.0


def _opt_lists(dev, p_dtype, g_dtype, seed, sizes=MT_SIZES):
    params = {f"p{i}": t for i, t in enumerate(
        _mt_list(dev, p_dtype, seed, sizes))}
    grads = {n: t.to(g_dtype) for n, t in zip(params, _mt_list(
        dev, torch.float32, seed + 1, sizes, scale=1e-2))}
    return params, grads


ADAM_CASES = [("float32", "float32", dict(weight_decay=0.01)),
              ("float32", "float32", dict(weight_decay=0.01,
                                          adam_w_mode=False)),
              ("float32", "float32", dict(bias_correction=False,
                                          betas=(0.8, 0.99))),
              ("float32", "float32", dict(learning_rate="schedule")),
              ("bfloat16", "bfloat16", dict(weight_decay=0.01)),
              ("bfloat16", "float32", dict()),
              ("float16", "float16", dict())]


def _schedule(c):
    return 1e-3 * torch.clamp(c / 3.0, max=1.0)


def _copy(tree):
    return {n: t.clone() for n, t in tree.items()}


def _state_tensors(state):
    out = {"count": state.count}
    out.update({f"m.{n}": t for n, t in state.m.items()})
    out.update({f"v.{n}": t for n, t in state.v.items()})
    return out


@pytest.mark.parametrize("p_dtype,g_dtype,kw", ADAM_CASES)
@pytest.mark.parametrize("many", [False, True])
def test_adam_kernel_matches_plain_bit_for_bit(dev, p_dtype, g_dtype, kw,
                                               many):
    """Three steps of K14 (the fused form) against the plain update and
    selects on copies: p, m, v and count equal bit for bit; a step with
    the flag set leaves them all bitwise unchanged."""
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.optimizers._base import apply_plain

    kw = dict(kw)
    if kw.get("learning_rate") == "schedule":
        kw["learning_rate"] = _schedule
    tx = fused_adam(**kw)
    sizes = MT_SIZES * (12 if many else 1)
    params, _ = _opt_lists(dev, MT_DTYPES[p_dtype], MT_DTYPES[g_dtype], 5,
                           sizes)
    plain = _copy(params)
    state, pstate = tx.init(params), tx.init(plain)
    no = torch.tensor(False, device=dev)
    for step in range(3):
        _, grads = _opt_lists(dev, MT_DTYPES[p_dtype], MT_DTYPES[g_dtype],
                              10 + step, sizes)
        before = multi_tensor_cuda.adam.launches
        tx.step(grads, state, params, no)
        # one launch a list (one group of list_capacity() tensors at most)
        groups = -(-len(sizes + [0]) // multi_tensor_cuda.list_capacity())
        assert multi_tensor_cuda.adam.launches == before + groups == before + 1
        apply_plain(tx.update, grads, pstate, plain, no)
        for n in params:
            assert _same_bits(params[n], plain[n]), (step, n)
        got, want = _state_tensors(state), _state_tensors(pstate)
        assert all(_same_bits(got[k], want[k]) for k in got)
    kept = _copy(params), _copy(_state_tensors(state))
    tx.step(grads, state, params, torch.tensor(True, device=dev))
    assert all(_same_bits(params[n], kept[0][n]) for n in params)
    got = _state_tensors(state)
    assert all(_same_bits(got[k], kept[1][k]) for k in got)


LAMB_CASES = [dict(), dict(adam_w_mode=False), dict(weight_decay=0.0),
              dict(weight_decay=0.0, use_nvlamb=True), dict(max_grad_norm=0.0),
              dict(bias_correction=False, grad_averaging=False)]


def _lamb_errors(params, plain, state, pstate):
    """The largest error of K15's parameters and moments against the plain
    version's, relative to each tensor's largest magnitude."""
    got, want = _state_tensors(state), _state_tensors(pstate)
    got.update(params)
    want.update(plain)
    err = 0.0
    for k, w in want.items():
        if k == "count" or not w.numel():
            continue
        scale = w.float().abs().max().clamp(min=1e-30)
        err = max(err, ((got[k].float() - w.float()).abs().max()
                        / scale).item())
    return err


def _lamb_run(dev, kw, impl, p_dtype, sizes, steps=3):
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.optimizers._base import apply_plain

    tx = fused_lamb(1e-2, impl=impl, **kw)
    params, _ = _opt_lists(dev, p_dtype, torch.float32, 7, sizes)
    plain, again = _copy(params), _copy(params)
    states = [tx.init(t) for t in (params, plain, again)]
    no = torch.tensor(False, device=dev)
    for step in range(steps):
        _, grads = _opt_lists(dev, p_dtype, torch.float32, 20 + step, sizes)
        tx.step(grads, states[0], params, no)
        apply_plain(tx.update, grads, states[1], plain, no)
        tx.step(grads, states[2], again, no)
    return tx, params, plain, again, states


@pytest.mark.parametrize("kw", LAMB_CASES)
@pytest.mark.parametrize("impl", ["two_pass", "one_pass"])
def test_lamb_kernel_matches_plain_and_repeats(dev, kw, impl):
    """Three steps of K13 + K15 against the plain structure within
    MT_LAMB_TOL, two runs the same bits, and a step with the flag set
    leaving everything bitwise unchanged."""
    tx, params, plain, again, states = _lamb_run(dev, kw, impl,
                                                 torch.float32, MT_SIZES)
    assert _lamb_errors(params, plain, states[0], states[1]) <= MT_LAMB_TOL
    assert all(_same_bits(params[n], again[n]) for n in params)
    kept = _copy(params), _copy(_state_tensors(states[0]))
    _, grads = _opt_lists(dev, torch.float32, torch.float32, 30)
    tx.step(grads, states[0], params, torch.tensor(True, device=dev))
    assert all(_same_bits(params[n], kept[0][n]) for n in params)
    got = _state_tensors(states[0])
    assert all(_same_bits(got[k], kept[1][k]) for k in got)


def test_lamb_kernel_over_many_tensors_and_bf16_params(dev):
    for p_dtype, many in ((torch.float32, 12), (torch.bfloat16, 1)):
        _, params, plain, again, states = _lamb_run(
            dev, dict(), "two_pass", p_dtype, MT_SIZES * many)
        assert all(_same_bits(params[n], again[n]) for n in params)
        tol = MT_LAMB_TOL if p_dtype == torch.float32 else 2.0 ** -7
        assert _lamb_errors(params, plain, states[0], states[1]) <= tol


# K15 under forced plans: the default grid, one block, three, and 131
# (fewer blocks than items: each block walks several chunks and tiles);
# the sizes add a tensor of several chunks and a 1.1 M one
LAMB_PLAN_SIZES = MT_SIZES * 3 + [3 * multi_tensor_cuda.CHUNK + 7,
                                  (1100, 1000)]
FORCED_GRIDS = (1, 3, 131)


def test_lamb_kernel_bits_do_not_depend_on_the_plan(dev):
    """K15's p, m and v after two steps are the same bits under every
    forced grid and the default plan (the per-tensor sums keep one fixed
    order; the grid moves only which block does which work)."""
    from apex_tpu_torch.optimizers import fused_lamb

    tx = fused_lamb(1e-2, weight_decay=0.01)
    base, _ = _opt_lists(dev, torch.float32, torch.float32, 60,
                         LAMB_PLAN_SIZES)
    grads = [_opt_lists(dev, torch.float32, torch.float32, 61 + s,
                        LAMB_PLAN_SIZES)[1] for s in range(2)]
    default = multi_tensor_cuda.plan
    seen = []

    def run(force=None):
        params = _copy(base)
        state = tx.init(params)

        def forced(*a, **k):
            pl = default(*a, **k)
            seen.append(pl)
            return force(pl) if force else pl
        with mock.patch.object(multi_tensor_cuda, "plan", forced):
            for g in grads:
                tx.step(g, state, params, torch.tensor(False, device=dev))
        out = _state_tensors(state)
        out.update(params)
        return out

    want = run()
    assert seen and seen[-1].grid not in FORCED_GRIDS
    for grid in FORCED_GRIDS:
        got = run(lambda p: p._replace(grid=grid))
        assert all(_same_bits(got[k], want[k]) for k in want), grid


def test_lamb_kernel_raises_past_the_resident_grid(dev):
    """K15's cooperative launch on more blocks than the card holds at once
    is refused, and the wrapper raises (no plain fallback)."""
    from apex_tpu_torch.optimizers import fused_lamb

    tx = fused_lamb(1e-2)
    params, grads = _opt_lists(dev, torch.float32, torch.float32, 80)
    kept = _copy(params)
    state = tx.init(params)
    default = multi_tensor_cuda.plan
    big = mock.patch.object(multi_tensor_cuda, "plan", lambda *a, **k: default(
        *a, **k)._replace(grid=4096 * 132))
    with big, pytest.raises(RuntimeError, match="CUDA error"):
        tx.step(grads, state, params, torch.tensor(False, device=dev))
    torch.cuda.synchronize()
    assert all(_same_bits(params[n], kept[n]) for n in params)


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_multi_tensor_list_kernels_replay_in_a_cuda_graph(dev, opt):
    """A CUDA graph captures K14's or K15's one launch (K15's cooperative)
    and each replay gives the eager step's bits."""
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb

    tx = fused_adam(1e-3, weight_decay=0.01) if opt == "adam" \
        else fused_lamb(1e-2, weight_decay=0.01)
    params, grads = _opt_lists(dev, torch.float32, torch.float32, 70,
                               LAMB_PLAN_SIZES)
    eager = _copy(params)
    es = tx.init(eager)
    gs = tx.init(params)
    no = torch.tensor(False, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):     # warm-up: the library, its residency
        warm = _copy(params)
        tx.step(grads, tx.init(warm), warm, no)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        tx.step(grads, gs, params, no)
    for _ in range(2):
        graph.replay()
        tx.step(grads, es, eager, no)
        torch.cuda.synchronize()
        got, want = _state_tensors(gs), _state_tensors(es)
        got.update(params)
        want.update(eager)
        assert all(_same_bits(got[k], want[k]) for k in want)


def test_mixed_precision_lamb_runs_k13_k15_on_its_masters(dev):
    """bf16 parameters over fp32 flat masters: the fused form (K13 + K15
    on views of the flat buffer, 4-byte aligned at ragged offsets) against
    the plain update and selects, three steps: masters within
    MT_LAMB_TOL, parameters within one bf16 ulp (2^-7 relative)."""
    from apex_tpu_torch.optimizers import fused_mixed_precision_lamb
    from apex_tpu_torch.optimizers._base import apply_plain

    tx = fused_mixed_precision_lamb(1e-2)
    params, _ = _opt_lists(dev, torch.bfloat16, torch.bfloat16, 40)
    plain = _copy(params)
    state, pstate = tx.init(params), tx.init(plain)
    no = torch.tensor(False, device=dev)
    before = multi_tensor_cuda.lamb.launches
    for step in range(3):
        _, grads = _opt_lists(dev, torch.bfloat16, torch.bfloat16, 50 + step)
        tx.step(grads, state, params, no)
        apply_plain(tx.update, grads, pstate, plain, no)
    assert multi_tensor_cuda.lamb.launches == before + 3
    err = ((state.master_flat - pstate.master_flat).abs().max()
           / pstate.master_flat.abs().max()).item()
    assert err <= MT_LAMB_TOL
    for n in params:
        torch.testing.assert_close(params[n].float(), plain[n].float(),
                                   rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_training_step_launches_the_multi_tensor_kernels(dev, opt):
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.testing import GPTModel

    cfg = TransformerConfig(
        hidden_size=64, num_layers=2, num_attention_heads=4, vocab_size=128,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False,
        bf16=True)
    model = GPTModel(cfg, device=dev)
    tx = fused_adam(1e-3) if opt == "adam" else fused_lamb(1e-2)
    step = make_one_step(model, LossScaler(), tx)
    state, ss = tx.init(dict(model.named_parameters())), LossScaler().init(
        dev)
    ids = torch.randint(0, 128, (2, 64), device=dev)
    pos = torch.arange(64, device=dev)[None].expand(2, 64)
    wrappers = (multi_tensor_cuda.scale, multi_tensor_cuda.l2norm,
                multi_tensor_cuda.adam, multi_tensor_cuda.lamb)
    before = [w.launches for w in wrappers]
    losses = []
    for _ in range(3):
        state, ss, loss = step(state, ss, ids, pos, ids)
        losses.append(loss.item())
    ran = [w.launches - b for w, b in zip(wrappers, before)]
    assert ran == ([3, 0, 3, 0] if opt == "adam" else [3, 6, 0, 3])
    assert all(torch.isfinite(torch.tensor(losses)))
    assert state.count.item() == 3


# ---------------------------------------------------------------- K16 SGD

SGD_CASES = [("float32", "float32", dict(learning_rate=0.1, momentum=0.9,
                                         weight_decay=1e-4)),
             ("float32", "float32", dict(learning_rate=0.1)),
             ("float32", "float32", dict(learning_rate="schedule",
                                         momentum=0.9, nesterov=True)),
             ("float32", "float32", dict(learning_rate=0.05, momentum=0.9,
                                         dampening=0.1, weight_decay=0.01)),
             ("bfloat16", "float32", dict(learning_rate=0.1, momentum=0.9,
                                          weight_decay=1e-4)),
             ("float16", "float16", dict(learning_rate=0.1, momentum=0.9))]


@pytest.mark.parametrize("p_dtype,g_dtype,kw", SGD_CASES)
@pytest.mark.parametrize("many", [False, True])
def test_sgd_kernel_matches_plain_bit_for_bit(dev, p_dtype, g_dtype, kw,
                                              many):
    """Three steps of K16 (``fused_sgd``'s fused form) against the plain
    update and selects on copies: p, the buffers and the count equal bit
    for bit (the first step's ``buf = g`` included); a step with the flag
    set leaves them all bitwise unchanged."""
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.optimizers._base import apply_plain

    kw = dict(kw)
    if kw.get("learning_rate") == "schedule":
        kw["learning_rate"] = _schedule
    tx = fused_sgd(**kw)
    sizes = MT_SIZES * (12 if many else 1)
    params, _ = _opt_lists(dev, MT_DTYPES[p_dtype], MT_DTYPES[g_dtype], 5,
                           sizes)
    plain = _copy(params)
    state, pstate = tx.init(params), tx.init(plain)
    no = torch.tensor(False, device=dev)
    for step in range(3):
        _, grads = _opt_lists(dev, MT_DTYPES[p_dtype], MT_DTYPES[g_dtype],
                              10 + step, sizes)
        before = multi_tensor_cuda.sgd.launches
        tx.step(grads, state, params, no)
        groups = -(-len(sizes) // multi_tensor_cuda.capacity(4))
        assert multi_tensor_cuda.sgd.launches == before + groups
        apply_plain(tx.update, grads, pstate, plain, no)
        for n in params:
            assert _same_bits(params[n], plain[n]), (step, n)
            assert _same_bits(state.momentum_buf[n], pstate.momentum_buf[n])
        assert state.count.item() == pstate.count.item() == step + 1
    kept = _copy(params), _copy(state.momentum_buf)
    tx.step(grads, state, params, torch.tensor(True, device=dev))
    assert all(_same_bits(params[n], kept[0][n]) for n in params)
    assert all(_same_bits(state.momentum_buf[n], kept[1][n]) for n in params)
    assert state.count.item() == 3


@pytest.mark.parametrize("model_dtype", ["bfloat16", "float16", "float32"])
def test_sgd_kernel_writes_the_model_copy(dev, model_dtype):
    """K16's four-list form (amp O2): the fp32 masters stepped as the
    three-list form steps them, and each new master written into its
    model copy in the copy's dtype, as the cast of the plain path's."""
    from apex_tpu_torch.optimizers import fused_sgd

    tx = fused_sgd(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    masters, _ = _opt_lists(dev, torch.float32, torch.float32, 3)
    model = {n: t.to(MT_DTYPES[model_dtype]) for n, t in masters.items()}
    alone = _copy(masters)
    s1, s2 = tx.init(masters), tx.init(alone)
    no = torch.tensor(False, device=dev)
    for step in range(2):
        _, grads = _opt_lists(dev, torch.float32, torch.float32, 30 + step)
        tx.step(grads, s1, masters, no, model_params=model)
        tx.step(grads, s2, alone, no)
        for n in masters:
            assert _same_bits(masters[n], alone[n])
            assert _same_bits(model[n], alone[n].to(model[n].dtype))
    kept = _copy(model)
    tx.step(grads, s1, masters, torch.tensor(True, device=dev),
            model_params=model)
    assert all(_same_bits(model[n], kept[n]) for n in model)


# -------------------------------------------------------- K17 / K18 batch norm

# relative L2 of K17's y and K18's dx against the plain versions (fp32
# inside both; K17 and K18 repeat the plain version's roundings from the
# same statistics, rstd by the same rsqrtf as torch.rsqrt).
# On an H100 (tests/port/kernel_l2_errors.py) these cases and ResNet-50's
# widths measured at most 7.1e-6 (bf16), 4.2e-6 (fp16), 4.8e-8 (fp32) for
# y, 0 for dx, with K17's rstd then correctly rounded
BN_L2_TOL = {"bfloat16": 5e-5, "float16": 3e-5, "float32": 3e-7}
# K17's sums and K18's, and the saved mean and rstd, against the plain
# versions (fp32 sums over the rows in another order), relative to each
# one's largest magnitude: measured at most 5.6e-7 there
BN_STAT_TOL = 3e-6
# [M, C]: vectors of 16 bytes (C % 8 == 0 for bf16/fp16, % 4 for fp32) or
# single channels, one tile or several (2048), a partial tile (24: three
# vectors), one row, and ResNet-50's widest rows at a small batch
BN_SHAPES = [(257, 64), (1000, 3), (513, 24), (100, 2048), (1, 16),
             (8 * 56 * 56, 256), (3000, 1)]
# rows (a prime) that no slab count divides, C = 100 (single channels in
# bf16/fp16, 4-channel vectors in fp32), and more channel tiles than the
# card holds blocks of 512 threads (each block then walks several items)
BN_EDGE_SHAPES = [(10007, 256), (777, 100), (3, 76800)]


def _bn_case(dev, dtype, m, c, seed, affine=True, w_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(m, c, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
    dy = torch.randn(m, c, generator=gen, device=dev).to(dtype)
    wd = w_dtype or torch.float32
    w = b = None
    if affine:
        w = (torch.rand(c, generator=gen, device=dev) + 0.5).to(wd)
        b = torch.randn(c, generator=gen, device=dev).to(wd)
    rm = torch.randn(c, generator=gen, device=dev) * 0.1
    rv = torch.rand(c, generator=gen, device=dev) + 0.5
    return x, dy, w, b, rm, rv


def _stat_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)
            ).item()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", BN_SHAPES + BN_EDGE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fuse_relu", [False, True])
def test_batch_norm_kernels_match_plain(dev, dtype, shape, fuse_relu):
    """K17's two stages and K18's (the two-launch form, a group of ranks'
    with the all-reduce between them) against the plain versions: the sums,
    the saved mean and rstd, the running stats and the sums of the
    backward within ``BN_STAT_TOL``, y and dx within ``BN_L2_TOL``; two
    runs of each stage equal bit for bit."""
    from apex_tpu_torch.ops import batch_norm, batch_norm_cuda as bnc

    tdt = DTYPES[dtype][0]
    x, dy, w, b, rm, rv = _bn_case(dev, tdt, *shape, seed=1)
    stats = bnc.fwd_stats(x)
    assert _same_bits(stats, bnc.fwd_stats(x))
    ref = batch_norm.fwd_stats_reference(x)
    assert stats[-1].item() == shape[0]
    assert _stat_err(stats, ref) < BN_STAT_TOL
    rm2, rv2 = rm.clone(), rv.clone()
    y, mean, rstd = bnc.fwd_apply(x, stats, w, b, rm, rv, 1e-5, 0.1, True,
                                  fuse_relu)
    ry, rmean, rrstd = batch_norm.fwd_apply_reference(
        x, stats, w, b, rm2, rv2, 1e-5, 0.1, True, fuse_relu)
    assert y.dtype == tdt and y.shape == x.shape
    for got, want in ((mean, rmean), (rstd, rrstd), (rm, rm2), (rv, rv2)):
        assert _stat_err(got, want) < BN_STAT_TOL
    if fuse_relu:
        assert (y >= 0).all()
    assert _rel_l2(y, ry) < BN_L2_TOL[dtype]
    sums = bnc.bwd_stats(x, dy, mean, rstd, w, b, fuse_relu)
    assert _same_bits(sums, bnc.bwd_stats(x, dy, mean, rstd, w, b,
                                          fuse_relu))
    rsums = batch_norm.bwd_stats_reference(x, dy, mean, rstd, w, b,
                                           fuse_relu)
    assert _stat_err(sums, rsums) < BN_STAT_TOL
    dx = bnc.bwd_apply(x, dy, mean, rstd, w, b, sums, stats, True, fuse_relu)
    rdx = batch_norm.bwd_apply_reference(x, dy, mean, rstd, w, b, sums,
                                         stats, True, fuse_relu)
    assert dx.dtype == tdt and _rel_l2(dx, rdx) < BN_L2_TOL[dtype]


def _rel_l2(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    return ((out - ref).norm() / ref.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", BN_SHAPES + BN_EDGE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fuse_relu", [False, True])
def test_batch_norm_one_launch_matches_plain(dev, dtype, shape, fuse_relu):
    """K17 and K18 in one launch each (one rank) against the plain
    versions: the stats, the saved mean and rstd, the running stats and
    the backward's sums within ``BN_STAT_TOL``, y and dx within
    ``BN_L2_TOL``, and in eval (the backward from the running stats); two
    runs equal bit for bit."""
    from apex_tpu_torch.ops import batch_norm, batch_norm_cuda as bnc

    tdt = DTYPES[dtype][0]
    x, dy, w, b, rm, rv = _bn_case(dev, tdt, *shape, seed=3)
    rm1, rv1, rm2, rv2 = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    before = (bnc.fwd.launches, bnc.bwd.launches)
    y, mean, rstd, stats = bnc.fwd(x, w, b, rm, rv, 1e-5, 0.1, fuse_relu)
    again = bnc.fwd(x, w, b, rm1, rv1, 1e-5, 0.1, fuse_relu)
    for got, other in zip((y, mean, rstd, stats, rm, rv),
                          again + (rm1, rv1)):
        assert _same_bits(got, other)
    # y and the statistics after the sums from the kernel's own stats,
    # which are held against the plain stats on their own
    ry, rmean, rrstd = batch_norm.fwd_apply_reference(
        x, stats, w, b, rm2, rv2, 1e-5, 0.1, True, fuse_relu)
    assert stats[-1].item() == shape[0] and y.dtype == tdt
    for got, want in ((stats, batch_norm.fwd_stats_reference(x)),
                      (mean, rmean), (rstd, rrstd), (rm, rm2), (rv, rv2)):
        assert _stat_err(got, want) < BN_STAT_TOL
    assert _rel_l2(y, ry) < BN_L2_TOL[dtype]
    for training in (True, False):
        dx, sums = bnc.bwd(x, dy, mean, rstd, w, b, stats, training,
                           fuse_relu)
        dx2, sums2 = bnc.bwd(x, dy, mean, rstd, w, b, stats, training,
                             fuse_relu)
        assert _same_bits(dx, dx2) and _same_bits(sums, sums2)
        rsums = batch_norm.bwd_stats_reference(x, dy, mean, rstd, w, b,
                                               fuse_relu)
        rdx = batch_norm.bwd_apply_reference(x, dy, mean, rstd, w, b, sums,
                                             stats, training, fuse_relu)
        assert _stat_err(sums, rsums) < BN_STAT_TOL
        assert dx.dtype == tdt and _rel_l2(dx, rdx) < BN_L2_TOL[dtype]
    assert (bnc.fwd.launches, bnc.bwd.launches) == (before[0] + 2,
                                                    before[1] + 4)


def test_batch_norm_plans_fit_the_card(dev):
    """Every kernel's grid fits what the card holds at once (the
    cooperative launches refuse more) and its items cover the rows and
    channels once."""
    from apex_tpu_torch.ops import batch_norm_cuda as bnc

    for name in bnc.KINDS:
        for dtype in DTYPES.values():
            for vec in (1, bnc.vec_of(4096, dtype[0])):
                res = bnc.resident(name, dtype[0], vec, dev)
                assert res >= torch.cuda.get_device_properties(
                    dev).multi_processor_count
                for rows, c in BN_SHAPES + BN_EDGE_SHAPES:
                    if c % vec:
                        continue
                    p = bnc.plan(rows, c, vec, res)
                    assert 1 <= p.grid <= res
                    assert p.tiles * p.tx * vec >= c
                    assert (p.slabs - 1) * p.rows_per_slab < rows \
                        <= p.slabs * p.rows_per_slab


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batch_norm_kernels_eval_no_affine_and_mixed_dtypes(dev, dtype):
    """K17 stage 2 in eval (the running stats, left unchanged) and K18 in
    eval; without scale and bias; with fp32 scale and bias over a half
    activation (amp O1, and ``bn_init`` under O2) and bf16 ones over fp32;
    and element loads from a pointer off a 16-byte boundary."""
    from apex_tpu_torch.ops import batch_norm, batch_norm_cuda as bnc

    tdt = DTYPES[dtype][0]
    for affine, wdt in ((True, torch.float32), (False, None),
                        (True, torch.bfloat16)):
        x, dy, w, b, rm, rv = _bn_case(dev, tdt, 300, 64, 2, affine, wdt)
        keep = rm.clone(), rv.clone()
        y, mean, rstd = bnc.fwd_apply(x, None, w, b, rm, rv, 1e-5, 0.1,
                                      False, False)
        assert _same_bits(rm, keep[0]) and _same_bits(rv, keep[1])
        ry, rmean, rrstd = batch_norm.fwd_apply_reference(
            x, None, w, b, rm, rv, 1e-5, 0.1, False, False)
        assert _stat_err(rstd, rrstd) < BN_STAT_TOL
        assert _rel_l2(y, ry) < BN_L2_TOL[dtype]
        dx = bnc.bwd_apply(x, dy, mean, rstd, w, b, None, None, False, False)
        rdx = batch_norm.bwd_apply_reference(x, dy, mean, rstd, w, b, None,
                                             None, False, False)
        assert _rel_l2(dx, rdx) < BN_L2_TOL[dtype]
    base = torch.randn(64 * 33 + 1, device=dev).to(tdt)
    x = base[1:].view(33, 64)                  # 2 or 4 bytes off
    stats = bnc.fwd_stats(x)
    assert _stat_err(stats, batch_norm.fwd_stats_reference(x)) < BN_STAT_TOL


def test_batch_norm_stages_launch_once_each_and_sync_batchnorm_raises(dev):
    """SyncBatchNorm's forward and backward on the card (one rank) launch
    K17 and K18 once each, in their one-launch forms, and no two-launch
    stage; the module raises on a 4-D channels-first activation instead of
    copying it, and the wrappers raise on rows they do not take."""
    from apex_tpu_torch.ops import batch_norm_cuda as bnc
    from apex_tpu_torch.parallel import SyncBatchNorm

    bn = SyncBatchNorm(32, channel_last=False, device=dev)
    x = torch.randn(4, 32, 7, 7, device=dev).to(
        memory_format=torch.channels_last).requires_grad_()
    fns = (bnc.fwd, bnc.bwd, bnc.fwd_stats, bnc.fwd_apply, bnc.bwd_stats,
           bnc.bwd_apply)
    before = [f.launches for f in fns]
    bn(x).square().sum().backward()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 0, 0, 0,
                                                             0]
    assert bn.weight.grad is not None and x.grad.shape == x.shape
    with pytest.raises(ValueError, match="channels_last"):
        bn(torch.randn(4, 32, 7, 7, device=dev))
    with pytest.raises(ValueError):
        bnc.fwd_stats(torch.randn(4, 32, 7, device=dev))
    with pytest.raises(ValueError):
        bnc.fwd_stats(torch.randn(8, 32, device=dev).t())


# ------------------------------------------------------------ K19 - K22
# (the relative-L2 numbers of K22 on the card: tests/port/kernel_l2_errors.py)

from apex_tpu_torch.ops import collectives as codec  # noqa: E402
from apex_tpu_torch.ops import collectives_cuda  # noqa: E402
from apex_tpu_torch.ops import zero as zero_ops  # noqa: E402
from apex_tpu_torch.optimizers._fused import ShardLayout  # noqa: E402

# BERT-large's flat gradient (the port's BertModel at BERT_LARGE's widths)
BERT_LARGE_FLAT = 336_297_858


def _codec_input(dev, n, rows=1, seed=0, poison=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, n, generator=gen, device=dev) * 10
    res = torch.randn(rows, n, generator=gen, device=dev) * 0.01
    if poison and n > 700:
        x[0, 128:256] = 0.0
        x[0, 300] = float("inf")
        x[0, 600] = float("nan")
        x[-1, 700] = float("-inf")
    return (x[0], res[0]) if rows == 1 else (x, res)


@pytest.mark.parametrize("n,rows", [(1, 1), (127, 1), (300, 1), (1000, 1),
                                    (501, 2), (250, 4), (65536, 2)])
def test_quantize_kernel_is_its_plain_version(dev, n, rows):
    x, res = _codec_input(dev, n, rows)
    for r in (None, res):
        got = collectives_cuda.quantize(x, r)
        want = codec.quantize_reference(x, r)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert _same_bits(g, w), (n, rows)
    # the new residual is a tensor of its own; the residual is only read
    r = res.clone()
    _, _, out = collectives_cuda.quantize(x, r)
    assert out.data_ptr() != r.data_ptr() and _same_bits(r, res)


def test_quantize_kernel_at_bert_large_flat_size(dev):
    x, res = _codec_input(dev, BERT_LARGE_FLAT, seed=3)
    got = collectives_cuda.quantize(x, res)
    want = codec.quantize_reference(x, res)
    for g, w in zip(got, want):
        assert _same_bits(g, w)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n", [1, 255, 1000, 65539])
def test_dequantize_sum_kernel_is_its_plain_version(dev, world, n):
    x, res = _codec_input(dev, n, world, seed=world, poison=False)
    q, s, _ = codec.quantize_reference(x, res)
    for kw in ({}, {"divisor": world}, {"gather": True}):
        got = collectives_cuda.dequantize_sum(q, s, n, **kw)
        want = codec.dequantize_sum_reference(q, s, n, **kw)
        assert _same_bits(got, want), kw


def test_codec_wrappers_refuse_what_the_kernels_do_not_take(dev):
    for block in (0, -128, 2.5):
        with pytest.raises(ValueError):
            collectives_cuda.quantize(torch.ones(8, device=dev), block=block)
    with pytest.raises(ValueError):
        collectives_cuda.quantize(torch.ones(8, device=dev).half())
    with pytest.raises(ValueError):
        collectives_cuda.quantize(torch.ones(4, 8, device=dev)[:, ::2])
    q, s, _ = collectives_cuda.quantize(torch.ones(2, 8, device=dev))
    with pytest.raises(ValueError):
        collectives_cuda.dequantize_sum(q, s, 129)
    with pytest.raises(ValueError):
        collectives_cuda.dequantize_sum(q, s, 8, gather=True, divisor=2)


# blocks other than the default 128: those the smoke runs (32, 64, 256),
# ones that are not a multiple of 4 (four consecutive elements then
# straddle blocks), 1, and one past 128 that is not a multiple of it
CODEC_BLOCKS = [32, 64, 256, 1, 3, 100, 1000]


@pytest.mark.parametrize("block", CODEC_BLOCKS)
@pytest.mark.parametrize("n,rows", [(1, 1), (300, 1), (1000, 1), (501, 2),
                                    (65539, 2)])
def test_quantize_kernel_takes_any_block(dev, block, n, rows):
    x, res = _codec_input(dev, n, rows, seed=block)
    for r in (None, res):
        got = collectives_cuda.quantize(x, r, block=block)
        want = codec.quantize_reference(x, r, block=block)
        assert got[0].shape[-1] == block
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert _same_bits(g, w), (block, n, rows)


@pytest.mark.parametrize("block", CODEC_BLOCKS)
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n", [1, 255, 1001, 65539])
def test_dequantize_sum_kernel_takes_any_block(dev, block, world, n):
    x, res = _codec_input(dev, n, world, seed=world + block, poison=False)
    x[0, n // 2] = float("inf")            # one block's scale is inf
    q, s, _ = codec.quantize_reference(x, res, block=block)
    for kw in ({}, {"divisor": world}, {"gather": True}):
        got = collectives_cuda.dequantize_sum(q, s, n, **kw)
        want = codec.dequantize_sum_reference(q, s, n, **kw)
        assert _same_bits(got, want), (block, kw)


def _adam_kw(wd, adam_w, bias):
    return dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
                adam_w_mode=adam_w, bias_correction=bias)


@pytest.mark.parametrize("wd,adam_w,bias", [(0.0, True, True),
                                            (0.01, False, True),
                                            (0.01, True, False)])
def test_zero_adam_kernel_is_its_plain_version_and_k14(dev, wd, adam_w,
                                                       bias):
    n = 3 * multi_tensor_cuda.CHUNK + 7
    gen = torch.Generator(device=dev).manual_seed(11)
    g, p = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    m = torch.randn(n, generator=gen, device=dev) * 0.1
    v = torch.rand(n, generator=gen, device=dev) * 0.01
    count = torch.tensor(4, dtype=torch.int32, device=dev)
    kw = _adam_kw(wd, adam_w, bias)
    for skip in (None, torch.tensor(False, device=dev),
                 torch.tensor(True, device=dev)):
        new = count + 1
        t = new.float()
        bc1, bc2 = (1.0 - torch.pow(0.9, t), 1.0 - torch.pow(0.999, t)) \
            if bias else (None, None)
        a = [x.clone() for x in (p, m, v, count)]
        b = [x.clone() for x in (p, m, v, count)]
        u = multi_tensor_cuda.zero_adam(g, a[0], a[1], a[2], a[3], new, bc1,
                                        bc2, 1e-3, skip=skip, **kw)
        ur = zero_ops.adam_reference(g, b[0], b[1], b[2], b[3], new, bc1,
                                     bc2, 1e-3, skip=skip, **kw)
        assert _same_bits(u, ur)
        assert all(_same_bits(x, y) for x, y in zip(a, b))
        if skip is not None and skip.item():
            assert all(_same_bits(x, y) for x, y in zip(a, (p, m, v, count)))
        elif skip is None:
            # K14 on the same fp32 shard as one tensor
            c = [x.clone() for x in (p, m, v, count)]
            multi_tensor_cuda.adam([g], [c[0]], [c[1]], [c[2]], c[3], new,
                                   bc1, bc2, 1e-3, **kw)
            assert all(_same_bits(x, y) for x, y in zip(a, c))


def _lamb_case(dev, sizes, shards, index, seed):
    layout = ShardLayout(sizes, shards, index)
    n = layout.shard
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=dev) * 0.1
    p = torch.randn(n, generator=gen, device=dev)
    m = torch.randn(n, generator=gen, device=dev) * 0.01
    v = torch.rand(n, generator=gen, device=dev) * 1e-3
    off = sum(sizes)
    pad_from = off - layout.start
    if 0 <= pad_from < n:               # the padding is zero, as the state's
        g[pad_from:] = 0.0
        p[pad_from:] = 0.0
    return layout, g, p, m, v


LAMB_LAYOUTS = [([70000, 3, 130001, 5], 2, 0), ([70000, 3, 130001, 5], 2, 1),
                ([1, 65536, 65537, 7, 300000], 4, 2), ([17], 2, 1)]


@pytest.mark.parametrize("sizes,shards,index", LAMB_LAYOUTS)
@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_zero_lamb_kernel_is_near_its_plain_version(dev, sizes, shards,
                                                    index, wd):
    layout, g, p, m, v = _lamb_case(dev, sizes, shards, index, 5)
    count = torch.tensor(2, dtype=torch.int32, device=dev)
    new = count + 1
    t = new.float()
    bc1, bc2 = 1.0 - torch.pow(0.9, t), 1.0 - torch.pow(0.999, t)
    gsq = torch.sum(g * g) * 3.0
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6, weight_decay=wd,
              adam_w_mode=True, bias_correction=True, max_grad_norm=1.0,
              global_sq=gsq)
    for skip in (None, torch.tensor(True, device=dev)):
        a = [x.clone() for x in (p, m, v, count)]
        b = [x.clone() for x in (p, m, v, count)]
        u, sums = multi_tensor_cuda.zero_lamb_stage1(
            g, a[0], a[1], a[2], layout, a[3], new, bc1, bc2, skip=skip,
            **kw)
        ur, sr = zero_ops.lamb_stage1_reference(
            g, b[0], b[1], b[2], layout, b[3], new, bc1, bc2, skip=skip,
            **kw)
        assert _same_bits(u, ur)
        assert all(_same_bits(x, y) for x, y in zip(a, b))
        assert ((sums - sr).abs().max() / sr.abs().max()).item() \
            <= MT_LAMB_TOL
        trust = wd != 0.0
        multi_tensor_cuda.zero_lamb_stage2(u, a[0], sums, layout, 1e-3,
                                           trust=trust, skip=skip)
        zero_ops.lamb_stage2_reference(ur, b[0], sr, layout, 1e-3,
                                       trust=trust, skip=skip)
        assert _rel_l2(u, ur) <= MT_LAMB_TOL
        if skip is not None:
            assert all(_same_bits(x, y) for x, y in zip(a, (p, m, v, count)))
        else:
            assert _rel_l2(a[0] - p, b[0] - p) <= MT_LAMB_TOL
    # two runs give the same bits
    outs = []
    for _ in range(2):
        a = [x.clone() for x in (p, m, v, count)]
        u, sums = multi_tensor_cuda.zero_lamb_stage1(
            g, a[0], a[1], a[2], layout, a[3], new, bc1, bc2, **kw)
        outs.append(sums)
    assert _same_bits(outs[0], outs[1])


def test_zero_transforms_and_codec_launch_their_kernels(dev):
    """On one rank (no process group): a DistributedFusedAdam step
    launches K21 once, a DistributedFusedLAMB step K22 three times, with
    int8 each K19 twice and K20 twice (the gradient hop and the update
    hop), and allreduce_tree with int8 K19 and K20 once each."""
    from apex_tpu_torch.contrib.optimizers import (distributed_fused_adam,
                                                   distributed_fused_lamb)
    from apex_tpu_torch.parallel import collectives

    params = {"a": torch.randn(300, 7, device=dev),
              "b": torch.randn(5, device=dev)}
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    fns = (collectives_cuda.quantize, collectives_cuda.dequantize_sum,
           multi_tensor_cuda.zero_adam, multi_tensor_cuda.zero_lamb_stage1,
           multi_tensor_cuda.zero_lamb_stage2)
    for make, want in ((distributed_fused_adam, [2, 2, 1, 0, 0]),
                       (distributed_fused_lamb, [2, 2, 0, 2, 1])):
        tx = make(learning_rate=1e-3, num_shards=1, grad_compress="int8")
        state = tx.init(params)
        before = [f.launches for f in fns]
        tx.step(grads, state, params)
        assert [f.launches - b for f, b in zip(fns, before)] == want
    before = [f.launches for f in fns]
    ef = collectives.ef_init(grads, None, compress="int8")
    out, ef = collectives.allreduce_tree(grads, None, compress="int8",
                                         ef_state=ef)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 0, 0, 0]
    assert out["a"].dtype == torch.float32 and ef.is_cuda


# ------------------------------------------------------------ K23

from apex_tpu_torch.ops import qmatmul as qmm  # noqa: E402
from apex_tpu_torch.ops import qmatmul_cuda  # noqa: E402
from apex_tpu_torch.serving import quant  # noqa: E402

# relative L2 of K23's output against the plain version (the same fp32
# products summed in another order, then one rounding to the dtype, where
# a sum near a rounding boundary may round the other way); on an H100
# (tests/port/kernel_l2_errors.py) these cases measured at most 8.9e-6
# (bf16), 6.4e-6 (fp16) and 3.7e-7 (fp32), and the smoke's GPT-2-small
# shapes 1.7e-5 (bf16, the logits)
QMM_L2_TOL = {"bfloat16": 5e-5, "float16": 5e-5, "float32": 2e-6}
# [B, K, N]: GPT-2-small's decode matmuls at 8 slots (qkv, dense, h->4h,
# 4h->h, the logits), then edges
QMM_DECODE_SHAPES = [(8, 768, 2304), (8, 768, 768), (8, 768, 3072),
                     (8, 3072, 768), (8, 768, 50304)]
QMM_EDGE_SHAPES = [(1, 768, 768), (3, 16, 100), (9, 528, 33),
                   (17, 1040, 70), (16, 64, 32), (5, 4096, 4000),
                   # K past its last 64-column chunk by 1 and 3 steps of
                   # 16, N past its last 16-channel tile, B of 9 and 17
                   # (two and three n-tiles), 40 (two row groups)
                   (8, 80, 48), (9, 784, 2310), (17, 816, 770),
                   (40, 272, 130)]
# forced plans (ops/qmatmul_cuda.Plan: n-tiles, split, cluster, depth) at
# [B, K, N]: unsplit, split over a block's warps, over a cluster's blocks,
# both, more n-tiles than B needs, each depth
QMM_PLAN_CASES = [
    ((8, 3072, 768), [(1, 1, 1, 4), (1, 2, 1, 2), (1, 1, 8, 4), (1, 4, 8, 2),
                      (4, 4, 2, 2), (2, 4, 3, 4)]),
    ((9, 816, 770), [(2, 1, 1, 2), (2, 4, 3, 4), (3, 2, 6, 2), (4, 1, 2, 2)]),
    ((1, 768, 50304), [(1, 1, 1, 2), (1, 1, 1, 4), (1, 4, 3, 4)]),
]


def _qmm_case(dev, dtype, b, k, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, generator=gen, device=dev).to(dtype)
    w = torch.randn(n, k, generator=gen, device=dev) * 0.05
    w[n // 2] = 0.0                       # an all-zero row: scale 0
    wq, scale = quant.quantize_weight(w)
    return x, wq, scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", QMM_DECODE_SHAPES + QMM_EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_qmatmul_kernel_matches_plain(dev, dtype, shape):
    tdt = DTYPES[dtype][0]
    x, wq, scale = _qmm_case(dev, tdt, *shape)
    before = qmatmul_cuda.qmatmul.launches
    y = qmm.qmatmul(x, wq, scale, tdt)
    assert qmatmul_cuda.qmatmul.launches == before + 1
    ref = qmm.qmatmul_reference(x, wq, scale, tdt)
    assert y.dtype == tdt and y.shape == ref.shape
    assert torch.isfinite(y).all()
    assert (y[:, shape[2] // 2] == 0).all()
    err = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
    assert err <= QMM_L2_TOL[dtype], err
    assert torch.equal(qmm.qmatmul(x, wq, scale, tdt), y)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape,plans", QMM_PLAN_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else "plans")
def test_qmatmul_tensor_core_plans_match_plain(dev, dtype, shape, plans,
                                               monkeypatch):
    tdt = DTYPES[dtype][0]
    x, wq, scale = _qmm_case(dev, tdt, *shape, seed=1)
    ref = qmm.qmatmul_reference(x, wq, scale, tdt)
    for nt, split, cluster, depth in plans:
        p = qmatmul_cuda.Plan("tc", nt, split, cluster, depth)
        monkeypatch.setattr(qmatmul_cuda, "plan", lambda *_, p=p: p)
        y = qmatmul_cuda.qmatmul(x, wq, scale)
        assert torch.isfinite(y).all() and (y[:, shape[2] // 2] == 0).all()
        err = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
        assert err <= QMM_L2_TOL[dtype], (p, err)
        assert torch.equal(qmatmul_cuda.qmatmul(x, wq, scale), y), p


def test_qmatmul_refuses_plans_the_kernel_does_not_take(dev, monkeypatch):
    Plan = qmatmul_cuda.Plan
    bf = _qmm_case(dev, torch.bfloat16, 8, 128, 32)
    f32 = _qmm_case(dev, torch.float32, 8, 128, 32)
    bad = [(bf, Plan("simt")), (f32, Plan("tc", depth=2)),
           (bf, Plan("tc", 5, depth=2)), (bf, Plan("tc", 0, depth=2)),
           (bf, Plan("tc", 1, 3, depth=2)), (bf, Plan("tc", 1, 1, 9, 2)),
           (bf, Plan("tc", 1, 2, 2, 2)), (bf, Plan("tc")),
           (bf, Plan("tc", 1, 1, 1, 3)), (bf, Plan("tc", 3, 1, 1, 4)),
           (f32, Plan("simt", 2)), (f32, Plan("simt", depth=2)),
           (bf, Plan("wide"))]
    before = qmatmul_cuda.qmatmul.launches
    for args, p in bad:
        monkeypatch.setattr(qmatmul_cuda, "plan", lambda *_, p=p: p)
        with pytest.raises(ValueError):
            qmatmul_cuda.qmatmul(*args)
    assert qmatmul_cuda.qmatmul.launches == before


def test_qmatmul_graph_replays_equal_the_eager_call(dev):
    # K23 at the five decode shapes captured in one CUDA graph, replayed
    # twice into outputs poisoned with NaN between replays
    for tdt in (torch.bfloat16, torch.float16):
        cases = [_qmm_case(dev, tdt, *s, seed=i)
                 for i, s in enumerate(QMM_DECODE_SHAPES)]
        eager = [qmatmul_cuda.qmatmul(*c) for c in cases]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in cases:
                qmatmul_cuda.qmatmul(*c)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [qmatmul_cuda.qmatmul(*c) for c in cases]
        for _ in range(2):
            for o in outs:
                o.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            for o, e in zip(outs, eager):
                assert torch.equal(o, e)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_qmatmul_takes_an_x_off_a_16_byte_boundary(dev, dtype):
    # the tensor-core body reads x in 16-byte vectors (the wrapper copies
    # such an x), the CUDA-core body element by element: the same bits
    x, wq, scale = _qmm_case(dev, DTYPES[dtype][0], 8, 784, 96)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    off = buf[1:].view_as(x)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert torch.equal(qmatmul_cuda.qmatmul(off, wq, scale),
                       qmatmul_cuda.qmatmul(x, wq, scale))


def test_qmatmul_flattens_leading_axes_and_casts_to_the_compute_dtype(dev):
    x, wq, scale = _qmm_case(dev, torch.float32, 6, 96, 40)
    y = qmm.qmatmul(x.view(2, 3, 96), wq, scale, torch.bfloat16)
    assert y.shape == (2, 3, 40) and y.dtype == torch.bfloat16
    ref = qmm.qmatmul_reference(x, wq, scale, torch.bfloat16)
    err = ((y.view(6, 40).float() - ref.float()).norm()
           / ref.float().norm()).item()
    assert err <= QMM_L2_TOL["bfloat16"]


def test_qmatmul_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, wq, scale = _qmm_case(dev, torch.bfloat16, 4, 64, 32)
    bad = [
        (x, wq.float(), scale),                       # not int8
        (x, wq, scale.to(torch.bfloat16)),            # scale not fp32
        (x, wq, scale[:16]),                          # shapes disagree
        (x.t(), wq, scale),                           # not contiguous
        (x.cpu(), wq, scale),                         # another device
        (x[None], wq, scale),                         # not 2-D
    ]
    before = qmatmul_cuda.qmatmul.launches
    for args in bad:
        with pytest.raises(ValueError):
            qmatmul_cuda.qmatmul(*args)
    assert qmatmul_cuda.qmatmul.launches == before


# [B, K, N] at a K that is not a multiple of 16 (or of 64): one step of 8,
# one and a half steps, 100 (one chunk and a 36-column tail), 770 (twelve
# chunks and 2 columns); forced tensor-core plans (n-tiles, split,
# cluster, depth) on each, the element-load body
QMM_ANY_K_SHAPES = [(8, 8, 64), (8, 24, 100), (9, 100, 130), (17, 770, 770),
                    (1, 770, 48), (8, 100, 50304)]
QMM_ANY_K_PLANS = [(1, 1, 1, 4), (2, 1, 1, 2), (1, 4, 3, 4), (4, 2, 6, 2)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", QMM_ANY_K_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_qmatmul_takes_any_k(dev, dtype, shape, monkeypatch):
    """K23 at K not a multiple of 16: the plan's own launch, forced
    tensor-core plans of the element-load body (those the K takes), and a
    wq off a 16-byte boundary, each within ``QMM_L2_TOL`` and the same bits
    twice."""
    tdt = DTYPES[dtype][0]
    b, k, n = shape
    x, wq, scale = _qmm_case(dev, tdt, *shape, seed=k)
    ref = qmm.qmatmul_reference(x, wq, scale, tdt)

    def held(y, what):
        assert y.dtype == tdt and y.shape == ref.shape, what
        assert torch.isfinite(y).all() and (y[:, n // 2] == 0).all(), what
        err = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
        assert err <= QMM_L2_TOL[dtype], (what, err)

    p = qmatmul_cuda.plan(b, n, k, tdt, 132)
    assert p.body == ("simt" if tdt == torch.float32 else "tc_narrow")
    y = qmatmul_cuda.qmatmul(x, wq, scale)
    held(y, p)
    assert torch.equal(qmatmul_cuda.qmatmul(x, wq, scale), y)
    ragged = torch.empty(wq.numel() + 1, dtype=torch.int8, device=dev)
    off = ragged[1:].view_as(wq)
    off.copy_(wq)
    held(qmatmul_cuda.qmatmul(x, off, scale), "wq off 16 bytes")
    if tdt == torch.float32:
        return
    chunks = max(1, k // qmatmul_cuda.CHUNK)
    for nt, split, cluster, depth in QMM_ANY_K_PLANS:
        if split * cluster > chunks:
            continue
        q = qmatmul_cuda.Plan("tc_narrow", nt, split, cluster, depth)
        monkeypatch.setattr(qmatmul_cuda, "plan", lambda *_, q=q: q)
        y = qmatmul_cuda.qmatmul(x, wq, scale)
        held(y, q)
        assert torch.equal(qmatmul_cuda.qmatmul(x, wq, scale), y), q


def test_qmatmul_aligned_k_on_both_bodies_agree(dev, monkeypatch):
    """At a K the 16-byte-load body takes, its element-load form sums in
    the same order: the same bits."""
    x, wq, scale = _qmm_case(dev, torch.bfloat16, 9, 816, 770)
    for nt, split, cluster, depth in QMM_ANY_K_PLANS:
        got = []
        for body in ("tc", "tc_narrow"):
            q = qmatmul_cuda.Plan(body, nt, split, cluster, depth)
            monkeypatch.setattr(qmatmul_cuda, "plan", lambda *_, q=q: q)
            got.append(qmatmul_cuda.qmatmul(x, wq, scale))
        assert torch.equal(*got), (nt, split, cluster, depth)


def test_weight_quant_engine_at_hidden_100_serves_the_plain_tokens(dev):
    """An int8-weight engine at hidden 100 (every decode matrix at K 100
    or 400) launches K23 and serves the tokens of the same engine on K23's
    plain version, greedy, fp32."""
    from apex_tpu_torch.ops import qmatmul as qmm_ops

    cfg = TransformerConfig(
        hidden_size=100, num_layers=2, num_attention_heads=4,
        vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False)
    params = init_gpt_params(cfg, 0, dev)
    kw = dict(num_slots=4, page_size=16, num_pages=24, max_seq=64,
              prefill_len=64, prefill_requests=1, device=dev,
              cuda_graph=False)
    tokens = {}
    for plain in (False, True):
        qmatmul_cuda.qmatmul.launches = 0
        with (mock.patch.object(qmatmul_cuda, "qmatmul", lambda x, w, s:
                                qmm_ops.qmatmul_reference(x, w, s, x.dtype))
              if plain else contextlib.nullcontext()):
            eng = ServingEngine(cfg, params, weight_quant=True, **kw)
            reqs, _ = synthetic_trace(seed=4, n_requests=6, vocab=128,
                                      prompt_lo=3, prompt_hi=20, new_lo=2,
                                      new_hi=12)
            tokens[plain] = {r.rid: list(r.out_tokens)
                             for r in eng.run_trace(reqs)}
        if not plain:
            assert qmatmul_cuda.qmatmul.launches == eng.decode_steps * (
                4 * cfg.num_layers + 1)
    assert tokens[True] == tokens[False]


def test_weight_quant_engine_launches_k23_and_graphs_its_tokens(dev):
    cfg = TransformerConfig(
        hidden_size=64, num_layers=2, num_attention_heads=4, vocab_size=128,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False,
        bf16=True)
    params = init_gpt_params(cfg, 0, dev)
    kw = dict(num_slots=4, page_size=16, num_pages=24, max_seq=64,
              prefill_len=64, prefill_requests=1, device=dev)
    tokens = {}
    for graph in (False, True):
        qmatmul_cuda.qmatmul.launches = 0
        eng = ServingEngine(cfg, params, weight_quant=True, cuda_graph=graph,
                            **kw)
        assert eng.qparams is not None
        reqs, _ = synthetic_trace(seed=4, n_requests=6, vocab=128,
                                  prompt_lo=3, prompt_hi=20, new_lo=2,
                                  new_hi=12)
        tokens[graph] = {r.rid: list(r.out_tokens)
                         for r in eng.run_trace(reqs)}
        calls = 2 if graph else eng.decode_steps
        assert qmatmul_cuda.qmatmul.launches == calls * (
            4 * cfg.num_layers + 1)
    assert tokens[True] == tokens[False]
