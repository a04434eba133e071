"""Relative L2 error, ||kernel - plain|| / ||plain||, of every case the
card tests run for K1 (forward; in bf16/fp16 also the tensor-core cases
over several tiles), K3/K4 (layer norm), K5/K6 (attention backward, also
the tensor-core cases over several tiles), K1d and
K5d/K6d (the same with dropout), K7-K9 (the fused
LM head: loss and lse, dX, dE; K7 and K7p also with labels at the
vocabulary's edges), K7p with K8/K9 on vocabulary shards
(each against its plain version, and the shards combined against K7-K9
on the whole table), K2q (decode over int8 pages), K2 and K2q at their
split boundaries, and K10/K11 and K10L/K11L (the fused softmax, forward
and backward, up to 4096 keys and above), K1d/K5d/K6d on BERT's padding
route (non-causal, segment ids) and K10/K11 under its padding masks,
per dtype, at the attention
head dims 32-256, the decode head dims 32-512 and the layer-norm widths
64-12800 the card tests take. It prints one line per attention, LM-head,
int8-decode and softmax case and the worst value per kernel and dtype:
the numbers ``L2_TOL``, ``DROPOUT_L2_TOL``, ``K1_L2_TOL``, ``XENT_L2_TOL``,
``XENT_LOSS_TOL``, ``XENT_PARTIAL_TOL``, ``XENT_SHARD_DX_L2_TOL`` and
``SOFTMAX_L2_TOL`` and ``K2Q_L2_TOL`` in ``test_torch_kernels_cuda.py``
are set from (for K7
the largest |loss diff| over max(1, |loss|); for K10 also the largest |y
diff|, which ``SOFTMAX_TOL`` bounds). Then the multi-tensor kernels' card
cases: K13's norms (``MT_NORM_TOL``) over the ragged list repeated past
one launch's table, per dtype, and K15's parameters and moments after
three steps (``MT_LAMB_TOL``) against each plain LAMB structure and
option, each as the largest error over a tensor's largest magnitude.
Last, batch norm: K17's y and K18's dx by relative L2 (``BN_L2_TOL``)
and their sums and saved statistics over their largest magnitude
(``BN_STAT_TOL``) at the card tests' shapes and two of ResNet-50's, with
and without the fused ReLU, per dtype, in the one-launch forms and the
two-launch forms. Then K22 (the ZeRO LAMB shard
update) on the card tests' layouts (``LAMB_LAYOUTS``, with and without
weight decay): the update's relative L2 and the segment sums' error over
their largest magnitude against the plain version (``MT_LAMB_TOL``).
Last, K23 (the W8A16 decode matmul) by relative L2 at GPT-2-small's
decode shapes and the card tests' edges, per dtype, on the card
tests' forced tensor-core plans, and at the K that are not a multiple of
16 on the plan's launch and the forced element-load plans
(``QMM_L2_TOL``).
Needs a CUDA card:

    python3 tests/port/kernel_l2_errors.py
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import test_torch_kernels_cuda as cases  # noqa: E402
from apex_tpu_torch.ops import attention, attention_bwd_cuda  # noqa: E402
from apex_tpu_torch.ops import attention_cuda, layer_norm  # noqa: E402
from apex_tpu_torch.ops import layer_norm_cuda, xent, xent_cuda  # noqa: E402
from apex_tpu_torch.ops import decode_attention  # noqa: E402
from apex_tpu_torch.ops import decode_attention_cuda  # noqa: E402
from apex_tpu_torch.ops import softmax, softmax_cuda  # noqa: E402
from apex_tpu_torch.ops import multi_tensor, multi_tensor_cuda  # noqa: E402


def _l2(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_l2_errors: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    worst = {}

    def note(kernel, dtype, value):
        worst[(kernel, dtype)] = max(worst.get((kernel, dtype), 0.0), value)

    for dtype, (tdt, _) in sorted(cases.DTYPES.items()):
        for d in cases.ATTN_DIMS:
            for case in ("causal", "segments", "masked_row", "cross"):
                q, k, v, do, causal, seg = cases._attn_case(dev, tdt, d, case)
                s = d ** -0.5
                o = attention_cuda.prefill_attention(
                    q, k, v, causal=causal, sm_scale=s, segment_ids=seg)
                fwd = _l2(o, attention._dense_attention(q, k, v, causal, s,
                                                        seg))
                got = attention_bwd_cuda.attention_bwd(
                    q, k, v, o, do, causal=causal, sm_scale=s,
                    segment_ids=seg)
                ref = attention._attention_bwd_split(q, k, v, o, do, causal,
                                                     s, seg)
                bwd = [_l2(a, b) for a, b in zip(got, ref)]
                print(f"attention {dtype} d={d} {case}: K1 {fwd:.3e}, "
                      f"dq/dk/dv {bwd[0]:.3e} {bwd[1]:.3e} {bwd[2]:.3e}")
                note("K1", dtype, fwd)
                note("K5/K6", dtype, max(bwd))
            for case in ("causal", "segments"):
                for seed in cases.DROPOUT_SEEDS:
                    q, k, v, do, seg, sd = cases._drop_case(dev, tdt, d, case,
                                                            seed)
                    s, p = d ** -0.5, 0.1
                    kw = dict(causal=True, sm_scale=s, dropout_p=p,
                              dropout_seed=sd, segment_ids=seg)
                    o = attention_cuda.prefill_attention_dropout(q, k, v, **kw)
                    fwd = _l2(o, attention._dense_attention(q, k, v, True, s,
                                                            seg, p, sd))
                    got = attention_bwd_cuda.attention_bwd_dropout(q, k, v, o,
                                                                   do, **kw)
                    ref = attention._attention_bwd_split(q, k, v, o, do, True,
                                                         s, seg, p, sd)
                    bwd = [_l2(a, b) for a, b in zip(got, ref)]
                    print(f"attention dropout {dtype} d={d} {case} seed "
                          f"{seed}: K1d {fwd:.3e}, dq/dk/dv {bwd[0]:.3e} "
                          f"{bwd[1]:.3e} {bwd[2]:.3e}")
                    note("K1d", dtype, fwd)
                    note("K5d/K6d", dtype, max(bwd))
            if d == 64:
                # BERT's padding dropout route: non-causal, segment ids
                for s_len in cases.PAD_LENGTHS:
                    for seed in cases.DROPOUT_SEEDS:
                        q, k, v, do, seg, sd = cases._pad_case(dev, tdt,
                                                               s_len, seed)
                        s, p = d ** -0.5, 0.1
                        kw = dict(causal=False, sm_scale=s, dropout_p=p,
                                  dropout_seed=sd, segment_ids=seg)
                        o = attention_cuda.prefill_attention_dropout(
                            q, k, v, **kw)
                        fwd = _l2(o, attention._dense_attention(
                            q, k, v, False, s, seg, p, sd))
                        got = attention_bwd_cuda.attention_bwd_dropout(
                            q, k, v, o, do, **kw)
                        ref = attention._attention_bwd_split(
                            q, k, v, o, do, False, s, seg, p, sd)
                        bwd = [_l2(a, b) for a, b in zip(got, ref)]
                        print(f"attention padding dropout {dtype} s={s_len} "
                              f"seed {seed}: K1d {fwd:.3e}, dq/dk/dv "
                              f"{bwd[0]:.3e} {bwd[1]:.3e} {bwd[2]:.3e}")
                        note("K1d padding", dtype, fwd)
                        note("K5d/K6d padding", dtype, max(bwd))
            if tdt == torch.float32:
                continue
            for sq, sk in cases.TC_SHAPES:
                for case in ("causal", "segments", "dropout", "cross"):
                    q, k, v, causal, seg, sd = cases._k1_tc_case(
                        dev, tdt, d, sq, sk, case)
                    s = d ** -0.5
                    o = cases._k1(q, k, v, causal, s, seg, sd)
                    fwd = _l2(o, attention._dense_attention(
                        q, k, v, causal, s, seg, 0.1 if sd is not None
                        else 0.0, sd))
                    name = "K1d" if sd is not None else "K1"
                    print(f"prefill tiles {dtype} d={d} {sq}x{sk} {case}: "
                          f"{name} {fwd:.3e}")
                    note(name, dtype, fwd)
                for case in ("causal", "segments", "dropout"):
                    q, k, v, do, seg, sd = cases._tc_case(dev, tdt, d, sq,
                                                          sk, case)
                    s, p = d ** -0.5, (0.1 if case == "dropout" else 0.0)
                    o = attention._dense_attention(q, k, v, True, s, seg, p,
                                                   sd)
                    kw = dict(causal=True, sm_scale=s, segment_ids=seg)
                    if p:
                        got = attention_bwd_cuda.attention_bwd_dropout(
                            q, k, v, o, do, dropout_p=p, dropout_seed=sd,
                            **kw)
                    else:
                        got = attention_bwd_cuda.attention_bwd(q, k, v, o, do,
                                                               **kw)
                    ref = attention._attention_bwd_split(q, k, v, o, do, True,
                                                         s, seg, p, sd)
                    bwd = [_l2(a, b) for a, b in zip(got, ref)]
                    print(f"attention tiles {dtype} d={d} {sq}x{sk} {case}: "
                          f"dq/dk/dv {bwd[0]:.3e} {bwd[1]:.3e} {bwd[2]:.3e}")
                    note("K5d/K6d" if p else "K5/K6", dtype, max(bwd))
        for hidden in (64, 768, 1024, 4096, 8192, 100, 12288, 12800):
            for rows in (1, 37, 1000):
                for affine in (True, False):
                    gen = torch.Generator(device=dev).manual_seed(2)
                    x = (torch.randn(rows, hidden, generator=gen, device=dev)
                         * 3 + 1).to(tdt)
                    dy = cases._randn(gen, rows, hidden, dtype=tdt, dev=dev)
                    w = b = None
                    if affine:
                        w = torch.randn(hidden, generator=gen, device=dev)
                        b = torch.randn(hidden, generator=gen, device=dev)
                    y, mean, rstd = layer_norm_cuda.layer_norm_fwd(x, w, b,
                                                                   1e-5)
                    dx, _, _ = layer_norm_cuda.layer_norm_bwd(x, w, mean,
                                                              rstd, dy)
                    ry, rm, rr = layer_norm.layer_norm_fwd(x, w, b, 1e-5)
                    rdx, _, _ = layer_norm.layer_norm_bwd(x, w, rm, rr, dy)
                    note("K3/K4", dtype, max(_l2(y, ry), _l2(dx, rdx)))
        for n, V, h in cases.XENT_SHAPES:
            for eps in (0.0, 0.1):
                x, e, labels, dl = cases._xent_case(dev, tdt, n, V, h)
                loss, lse = xent_cuda.xent_fwd(x, e, labels, eps)
                dx = xent_cuda.xent_bwd_dx(x, e, labels, lse, dl, eps)
                de = xent_cuda.xent_bwd_de(x, e, labels, lse, dl, eps)
                rloss, rlse = xent.linear_cross_entropy_fwd(x, e, labels, eps)
                rdx = xent.linear_cross_entropy_dx(x, e, labels, rlse, dl, eps)
                rde = xent.linear_cross_entropy_de(x, e, labels, rlse, dl, eps)
                scale = max(rloss.abs().max().item(), 1.0)
                fwd = max((loss - rloss).abs().max().item(),
                          (lse - rlse).abs().max().item()) / scale
                bwd = [_l2(dx, rdx), _l2(de, rde)]
                print(f"xent {dtype} {n}x{V}x{h} eps={eps}: K7 loss/lse "
                      f"{fwd:.3e} (max diff over max(1, |loss|)), K8 dx "
                      f"{bwd[0]:.3e}, K9 de {bwd[1]:.3e}")
                note("K7", dtype, fwd)
                note("K8/K9", dtype, max(bwd))
        for n, V, h in cases.XENT_EDGE_SHAPES:
            for eps in (0.0, 0.1):
                x, e, labels, _ = cases._xent_case(dev, tdt, n, V, h)
                labels = cases._edge_labels(labels, V)
                loss, lse = xent_cuda.xent_fwd(x, e, labels, eps)
                part = xent_cuda.xent_fwd_partials(x, e, labels, eps)
                rloss, rlse = xent.linear_cross_entropy_fwd(x, e, labels, eps)
                rpart = torch.stack(xent.linear_cross_entropy_partials(
                    x, e, labels, eps))
                scale = max(rloss.abs().max().item(), 1.0)
                fwd = max((loss - rloss).abs().max().item(),
                          (lse - rlse).abs().max().item()) / scale
                parts = ((part - rpart).abs().amax(dim=1)
                         / rpart.abs().amax(dim=1).clamp(min=1.0)).max()
                print(f"xent edge labels {dtype} {n}x{V}x{h} eps={eps}: K7 "
                      f"loss/lse {fwd:.3e}, K7p partials {parts.item():.3e}")
                note("K7", dtype, fwd)
                note("K7p partials", dtype, parts.item())
        for n, V, h, tp in cases.XENT_SHARD_SHAPES:
            for eps in (0.0, 0.1):
                err = cases._xent_shard_errors(dev, tdt, n, V, h, tp, eps)
                print(f"xent shards {dtype} {n}x{V}x{h} tp={tp} eps={eps}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
                note("K7p partials", dtype, err["partials"])
                note("K7p combined loss/lse", dtype, err["combined_loss"])
                note("K8/K9 shard (v_total)", dtype,
                     max(err["dx_shard_l2"], err["de_shard_l2"],
                         err["de_cat_l2"]))
                note("K8 dX summed over shards", dtype, err["dx_sum_l2"])
        for d in cases.DECODE_DIMS:
            for ps in (16, 128):
                gen = torch.Generator(device=dev).manual_seed(3)
                h, pages, b = 4, 26, 6
                q = cases._randn(gen, b, h, d, dtype=tdt, dev=dev)
                (k8, ks, _), (v8, vs, _) = (
                    cases._quant_pages(gen, h, pages, ps, d, dev)
                    for _ in range(2))
                pt = torch.arange(1, 1 + b * 4, dtype=torch.int32,
                                  device=dev).reshape(b, 4)
                lengths = torch.tensor([1, ps - 1, ps + 1, 2 * ps, 3 * ps + 2,
                                        4 * ps], dtype=torch.int32,
                                       device=dev)
                out = decode_attention_cuda.decode_attention_quant(
                    q, k8, v8, ks, vs, pt, lengths, sm_scale=d ** -0.5)
                ref = decode_attention.decode_attention_reference(
                    q, k8, v8, pt, lengths, d ** -0.5, ks, vs)
                err = _l2(out, ref)
                print(f"int8 decode {dtype} d={d} ps={ps}: K2q {err:.3e}")
                note("K2q", dtype, err)
        for _, d, ps in cases.SPLIT_CASES:
            for quant in (False, True):
                q, kp, vp, (ks, vs), pt, lengths, sk = cases._split_case(
                    dev, tdt, d, ps, quant)
                out = decode_attention.decode_attention(
                    q, kp, vp, pt, lengths, sm_scale=d ** -0.5, k_scale=ks,
                    v_scale=vs)
                ref = decode_attention.decode_attention_reference(
                    q, kp, vp, pt.clamp(0, kp.shape[1] - 1), lengths,
                    d ** -0.5, ks, vs)
                err = _l2(out, ref)
                name = "K2q" if quant else "K2"
                print(f"decode splits {dtype} d={d} ps={ps} sk={sk}: {name} "
                      f"{err:.3e}")
                note(name, dtype, err)
        for shape in cases.SOFTMAX_SHAPES:
            for case in cases.SOFTMAX_CASES:
                x, g, mask, causal = cases._softmax_case(dev, tdt, shape,
                                                         case)
                y = softmax_cuda.softmax_fwd(x, mask, 0.37, causal)
                dx = softmax_cuda.softmax_bwd(y, g, 0.37)
                ry = softmax.scaled_masked_softmax_reference(x, mask, 0.37,
                                                             causal)
                rdx = softmax.scaled_masked_softmax_backward_reference(
                    y, g, 0.37)
                ymax = (y.float() - ry.float()).abs().max().item()
                fwd, bwd = _l2(y, ry), _l2(dx, rdx)
                print(f"softmax {dtype} {shape} {case}: K10 {fwd:.3e} (max "
                      f"|y diff| {ymax:.3e}), K11 {bwd:.3e}")
                note("K10", dtype, fwd)
                note("K10 max |y diff|", dtype, ymax)
                note("K11", dtype, bwd)
        for shape in cases.PAD_SOFTMAX_SHAPES:
            for case in cases.PAD_SOFTMAX_CASES:
                x, g, mask = cases._pad_softmax_case(dev, tdt, shape, case)
                y = softmax_cuda.softmax_fwd(x, mask, 24.0, False)
                dx = softmax_cuda.softmax_bwd(y, g, 24.0)
                ry = softmax.scaled_masked_softmax_reference(x, mask, 24.0,
                                                             False)
                rdx = softmax.scaled_masked_softmax_backward_reference(
                    y, g, 24.0)
                ymax = (y.float() - ry.float()).abs().max().item()
                fwd, bwd = _l2(y, ry), _l2(dx, rdx)
                print(f"softmax padding {dtype} {shape} {case}: K10 "
                      f"{fwd:.3e} (max |y diff| {ymax:.3e}), K11 {bwd:.3e}")
                note("K10 padding", dtype, fwd)
                note("K10 padding max |y diff|", dtype, ymax)
                note("K11 padding", dtype, bwd)
        for shape in cases.SOFTMAX_LONG_SHAPES:
            for case in cases.SOFTMAX_CASES:
                x, g, mask, causal = cases._softmax_case(dev, tdt, shape,
                                                         case)
                y = softmax_cuda.softmax_fwd_long(x, mask, 0.37, causal)
                dx = softmax_cuda.softmax_bwd_long(y, g, 0.37)
                ry = softmax.scaled_masked_softmax_reference(x, mask, 0.37,
                                                             causal)
                rdx = softmax.scaled_masked_softmax_backward_reference(
                    y, g, 0.37)
                ymax = (y.float() - ry.float()).abs().max().item()
                fwd, bwd = _l2(y, ry), _l2(dx, rdx)
                print(f"softmax long {dtype} {shape} {case}: K10L {fwd:.3e} "
                      f"(max |y diff| {ymax:.3e}), K11L {bwd:.3e}")
                note("K10L", dtype, fwd)
                note("K10L max |y diff|", dtype, ymax)
                note("K11L", dtype, bwd)
    for dtype, tdt in sorted(cases.MT_DTYPES.items()):
        xs = cases._mt_list(dev, tdt, 4, cases.MT_SIZES * 30)
        for max_mode in (False, True):
            err = cases._norm_errors(
                multi_tensor_cuda.l2norm(xs, max_mode),
                multi_tensor.l2norm_reference(xs, max_mode))
            name = "K13 max" if max_mode else "K13"
            print(f"multi-tensor norms {dtype}: {name} {err:.3e}")
            note(name, dtype, err)
    for impl in ("two_pass", "one_pass"):
        for kw in cases.LAMB_CASES:
            _, params, plain, _, states = cases._lamb_run(
                dev, kw, impl, torch.float32, cases.MT_SIZES)
            err = cases._lamb_errors(params, plain, states[0], states[1])
            print(f"lamb {impl} {kw}: K15 {err:.3e}")
            note("K15", "float32", err)
    from apex_tpu_torch.ops import batch_norm, batch_norm_cuda
    for dtype, (tdt, _) in sorted(cases.DTYPES.items()):
        for shape in cases.BN_SHAPES + cases.BN_EDGE_SHAPES + [
                (256 * 56 * 56, 256), (256 * 7 * 7, 2048)]:
            for relu in (False, True):
                x, dy, w, b, rm, rv = cases._bn_case(dev, tdt, *shape, seed=1)
                y, mean, rstd, stats = batch_norm_cuda.fwd(
                    x, w, b, rm.clone(), rv.clone(), 1e-5, 0.1, relu)
                ry, rmean, rrstd = batch_norm.fwd_apply_reference(
                    x, stats, w, b, rm.clone(), rv.clone(), 1e-5, 0.1, True,
                    relu)
                dx, sums = batch_norm_cuda.bwd(x, dy, mean, rstd, w, b,
                                               stats, True, relu)
                rsums = batch_norm.bwd_stats_reference(x, dy, mean, rstd, w,
                                                       b, relu)
                rdx = batch_norm.bwd_apply_reference(
                    x, dy, mean, rstd, w, b, sums, stats, True, relu)
                stat = max(cases._stat_err(stats, batch_norm.
                                           fwd_stats_reference(x)),
                           cases._stat_err(mean, rmean),
                           cases._stat_err(rstd, rrstd),
                           cases._stat_err(sums, rsums))
                fwd, bwd = _l2(y, ry), _l2(dx, rdx)
                print(f"batch norm, one launch, {dtype} {shape} relu {relu}: "
                      f"K17 {fwd:.3e}, K18 {bwd:.3e}, sums and statistics "
                      f"{stat:.3e}")
                note("K17", dtype, fwd)
                note("K18", dtype, bwd)
                note("K17/K18 sums", dtype, stat)
                stats = batch_norm_cuda.fwd_stats(x)
                y, mean, rstd = batch_norm_cuda.fwd_apply(
                    x, stats, w, b, rm, rv, 1e-5, 0.1, True, relu)
                ry, rmean, rrstd = batch_norm.fwd_apply_reference(
                    x, stats, w, b, rm.clone(), rv.clone(), 1e-5, 0.1, True,
                    relu)
                sums = batch_norm_cuda.bwd_stats(x, dy, mean, rstd, w, b,
                                                 relu)
                dx = batch_norm_cuda.bwd_apply(x, dy, mean, rstd, w, b, sums,
                                               stats, True, relu)
                rdx = batch_norm.bwd_apply_reference(
                    x, dy, mean, rstd, w, b, sums, stats, True, relu)
                stat = max(cases._stat_err(stats, batch_norm.
                                           fwd_stats_reference(x)),
                           cases._stat_err(mean, rmean),
                           cases._stat_err(rstd, rrstd),
                           cases._stat_err(sums, batch_norm.
                                           bwd_stats_reference(
                                               x, dy, mean, rstd, w, b,
                                               relu)))
                fwd, bwd = _l2(y, ry), _l2(dx, rdx)
                print(f"batch norm {dtype} {shape} relu {relu}: K17 "
                      f"{fwd:.3e}, K18 {bwd:.3e}, sums and statistics "
                      f"{stat:.3e}")
                note("K17", dtype, fwd)
                note("K18", dtype, bwd)
                note("K17/K18 sums", dtype, stat)
    from apex_tpu_torch.ops import zero

    for sizes, shards, index in cases.LAMB_LAYOUTS:
        for wd in (0.01, 0.0):
            layout, g, p, m, v = cases._lamb_case(dev, sizes, shards, index,
                                                  5)
            count = torch.tensor(2, dtype=torch.int32, device=dev)
            new = count + 1
            bc1 = 1.0 - torch.pow(0.9, new.float())
            bc2 = 1.0 - torch.pow(0.999, new.float())
            kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                      weight_decay=wd, adam_w_mode=True,
                      bias_correction=True, max_grad_norm=1.0,
                      global_sq=torch.sum(g * g) * 3.0)
            a = [t.clone() for t in (p, m, v, count)]
            b = [t.clone() for t in (p, m, v, count)]
            u, sums = multi_tensor_cuda.zero_lamb_stage1(
                g, a[0], a[1], a[2], layout, a[3], new, bc1, bc2, **kw)
            ur, sr = zero.lamb_stage1_reference(
                g, b[0], b[1], b[2], layout, b[3], new, bc1, bc2, **kw)
            multi_tensor_cuda.zero_lamb_stage2(u, a[0], sums, layout, 1e-3,
                                               trust=wd != 0)
            zero.lamb_stage2_reference(ur, b[0], sr, layout, 1e-3,
                                       trust=wd != 0)
            upd = _l2(u, ur)
            serr = ((sums - sr).abs().max() / sr.abs().max()).item()
            print(f"K22 {sizes} shard {index} of {shards} wd {wd}: update "
                  f"{upd:.3e}, sums {serr:.3e}")
            note("K22 update", torch.float32, upd)
            note("K22 sums", torch.float32, serr)
    from apex_tpu_torch.ops import qmatmul, qmatmul_cuda

    for dtype, (tdt, _) in sorted(cases.DTYPES.items()):
        for shape in cases.QMM_DECODE_SHAPES + cases.QMM_EDGE_SHAPES:
            x, wq, scale = cases._qmm_case(dev, tdt, *shape)
            err = _l2(qmatmul.qmatmul(x, wq, scale, tdt),
                      qmatmul.qmatmul_reference(x, wq, scale, tdt))
            print(f"K23 {dtype} {shape}: {err:.3e}")
            note("K23", dtype, err)
        if tdt == torch.float32:
            continue
        chosen = qmatmul_cuda.plan
        for shape, plans in cases.QMM_PLAN_CASES:
            x, wq, scale = cases._qmm_case(dev, tdt, *shape, seed=1)
            ref = qmatmul.qmatmul_reference(x, wq, scale, tdt)
            for nt, split, cluster, depth in plans:
                p = qmatmul_cuda.Plan("tc", nt, split, cluster, depth)
                qmatmul_cuda.plan = lambda *_, p=p: p
                try:
                    err = _l2(qmatmul_cuda.qmatmul(x, wq, scale), ref)
                finally:
                    qmatmul_cuda.plan = chosen
                print(f"K23 {dtype} {shape} {p}: {err:.3e}")
                note("K23", dtype, err)
    for dtype, (tdt, _) in sorted(cases.DTYPES.items()):
        for shape in cases.QMM_ANY_K_SHAPES:
            x, wq, scale = cases._qmm_case(dev, tdt, *shape, seed=shape[1])
            ref = qmatmul.qmatmul_reference(x, wq, scale, tdt)
            err = _l2(qmatmul_cuda.qmatmul(x, wq, scale), ref)
            print(f"K23 any K {dtype} {shape}: {err:.3e}")
            note("K23", dtype, err)
            if tdt == torch.float32:
                continue
            chunks = max(1, shape[1] // qmatmul_cuda.CHUNK)
            for nt, split, cluster, depth in cases.QMM_ANY_K_PLANS:
                if split * cluster > chunks:
                    continue
                p = qmatmul_cuda.Plan("tc_narrow", nt, split, cluster, depth)
                qmatmul_cuda.plan = lambda *_, p=p: p
                try:
                    err = _l2(qmatmul_cuda.qmatmul(x, wq, scale), ref)
                finally:
                    qmatmul_cuda.plan = chosen
                print(f"K23 any K {dtype} {shape} {p}: {err:.3e}")
                note("K23", dtype, err)
    for (kernel, dtype), value in sorted(worst.items()):
        print(f"worst {kernel} {dtype}: {value:.3e}")


if __name__ == "__main__":
    main()
