"""Chip smoke of the PyTorch + CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before printing any result. It imports nothing of JAX
and nothing of ``apex_tpu``. Phases, in order (any failure raises and
exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 is switched off for fp32 matmuls and convolutions.
2. build: both CUDA kernels compile from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` each, in parallel) into ``build/apex_tpu_torch/``.
3. one phase per kernel at the serving path's shapes: the kernel against
   its plain PyTorch version on the card (bf16, stated tolerance); its
   time, the plain version's and one PyTorch call's (``library_ms``,
   timed here, never used by the port), each over launches that find the
   50 MB L2 cache flushed; and the least time an H100 SXM could take for
   the same work (``bound_ms``: bytes each input read and output written
   once over 3.35 TB/s, or the work this run's masks leave over 989
   TFLOP/s bf16, whichever is larger — NVIDIA's data-sheet rates).
4. end to end: ``ServingEngine`` at GPT-2-small width (12 x 768, 12
   heads, vocab 50304, 1024 positions, bf16; 8 slots, page size 128, 72
   pages, 512-token packed prefill) with random weights from seed 0
   serves a seeded synthetic trace to completion. The launch counts of
   both kernels are read around that run alone and must equal
   ``prefill_batches x 12`` and ``decode_steps x 12``. Then one packed
   prefill batch and 4 decode steps run through the kernel path and the
   plain path on the card, and their logits must agree within 0.35 (the
   bf16 band of the JAX package's serving tests).
5. a second short trace replays under ``torch.profiler``: the device's
   busy share of that window and its kernel time by kind.
6. one JSON line per kernel, the ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from unittest import mock

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense
L2_FLUSH_BYTES = 128 << 20    # > the 50 MB L2 cache
LOGITS_BAND = 0.35

# the serving configuration the repo benchmarks (GPT-2 small)
MODEL = dict(hidden_size=768, num_layers=12, num_attention_heads=12,
             vocab_size=50304, max_position_embeddings=1024,
             hidden_dropout=0.0, attention_dropout=0.0,
             apply_query_key_layer_scaling=False, bf16=True)
ENGINE = dict(num_slots=8, page_size=128, num_pages=72, max_seq=1024,
              prefill_len=512)
TRACE = dict(seed=0, n_requests=24, prompt_lo=16, prompt_hi=320,
             new_lo=16, new_hi=96, mean_interarrival=0.5)


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, flush, reps=20):
    """Mean device time of ``fn`` over ``reps`` launches, each after an
    L2 flush, timed with CUDA events. A spin of ~0.5 ms on the stream
    before each timed launch lets the host queue all of ``fn``'s work
    first, so host overhead does not land inside the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _max_err(out, ref):
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out - ref).abs().max().item()


def phase_prefill_kernel(dev, flush):
    """K1 at S=512, H=12, d=64 with 3 packed segments plus padding."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention, attention_cuda

    H, S, D = 12, 512, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(1, H, S, D, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    seg = torch.zeros(1, S, dtype=torch.int32, device=dev)
    for sid, (lo, hi) in enumerate(((0, 200), (200, 330), (330, 471)), 1):
        seg[0, lo:hi] = sid           # 471..511 is padding on segment 0
    scale = D ** -0.5
    tol = 5e-2  # bf16 outputs (half ulp 7.8e-3 at |o| < 4, each side) and
    #             the plain version rounds its probabilities to bf16 before
    #             the value product (up to 2^-8 relative of sum p|v|)
    before = attention_cuda.prefill_attention.launches
    out = attention_cuda.prefill_attention(
        q, k, v, causal=True, sm_scale=scale, segment_ids=(seg, seg))
    if attention_cuda.prefill_attention.launches != before + 1:
        raise AssertionError("prefill kernel launch was not counted")
    ref = attention._dense_attention(q, k, v, True, scale, (seg, seg))
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    _log(f"prefill_attention: max_abs_err {err:.3e} (tol {tol})")
    if err > tol:
        raise AssertionError(f"prefill kernel disagrees: {err} > {tol}")

    pos = torch.arange(S, device=dev)
    allowed = (pos[None, :] <= pos[:, None]) & (seg[0][None, :]
                                                == seg[0][:, None])
    ms = _time_ms(lambda: attention_cuda.prefill_attention(
        q, k, v, causal=True, sm_scale=scale, segment_ids=(seg, seg)),
        flush)
    plain_ms = _time_ms(lambda: attention._dense_attention(
        q, k, v, True, scale, (seg, seg)), flush)
    mask = allowed[None, None]
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), flush)
    nbytes = 4 * q.numel() * q.element_size() + 2 * seg.numel() * 4
    flops = 4 * H * D * int(allowed.sum().item())   # QK^T and PV, live pairs
    bound_ms, bound_by = _bound(nbytes, flops)
    return {
        "name": "prefill_attention", "route": "cuda",
        "source": "apex_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "apex_tpu/ops/attention_pallas.py:230",
        "shape": f"q,k,v [1,{H},{S},{D}] bf16, 3 segments + padding",
        "max_abs_err": err, "tol": tol, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention, boolean mask",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops}


def phase_decode_kernel(dev, flush):
    """K2 at B=8, H=12, ps=128, 72 pages, mixed lengths incl. 0/1/127/
    128/129/1024."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attention, decode_attention_cuda

    B, H, D, PS, P, MAXP = 8, 12, 64, 128, 72, 8
    lengths_l = [0, 1, 127, 128, 129, 1024, 513, 300]
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(H, P, PS, D, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))
    pt = torch.zeros(B, MAXP, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths_l):
        for j in range(-(-n // PS)):
            pt[i, j] = int(perm[nxt]) + 1     # fragmented, never page 0
            nxt += 1
    pt = pt.to(dev)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    tol = 2e-2  # fp32 inside both; bf16 output, one ulp at |o| < 4
    before = decode_attention_cuda.decode_attention.launches
    out = decode_attention_cuda.decode_attention(q, kp, vp, pt, lengths,
                                                 sm_scale=scale)
    if decode_attention_cuda.decode_attention.launches != before + 1:
        raise AssertionError("decode kernel launch was not counted")
    ref = decode_attention.decode_attention_reference(q, kp, vp, pt,
                                                      lengths, scale)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    _log(f"decode_attention: max_abs_err {err:.3e} (tol {tol})")
    if err > tol:
        raise AssertionError(f"decode kernel disagrees: {err} > {tol}")
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("an inactive slot (length 0) must give 0")

    ms = _time_ms(lambda: decode_attention_cuda.decode_attention(
        q, kp, vp, pt, lengths, sm_scale=scale), flush)
    plain_ms = _time_ms(lambda: decode_attention.decode_attention_reference(
        q, kp, vp, pt, lengths, scale), flush)
    # the yardstick attends over K/V gathered beforehand (gather excluded)
    kg = kp[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * PS, D)
    vg = vp[:, pt].permute(1, 0, 2, 3, 4).reshape(B, H, MAXP * PS, D)
    live = (torch.arange(MAXP * PS, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=live, scale=scale), flush)
    tokens = sum(lengths_l)
    nbytes = (2 * tokens * H * D * kp.element_size()
              + 2 * q.numel() * q.element_size()
              + pt.numel() * 4 + lengths.numel() * 4)
    flops = 4 * H * D * tokens
    bound_ms, bound_by = _bound(nbytes, flops)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "apex_tpu_torch/csrc/decode_attention.cu",
        "replaces": "apex_tpu/ops/decode_attention_pallas.py:142",
        "shape": (f"q [{B},{H},{D}] bf16, pages [{H},{P},{PS},{D}], "
                  f"lengths {lengths_l}"),
        "max_abs_err": err, "tol": tol, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": ("F.scaled_dot_product_attention over pre-gathered "
                    "contiguous K/V (gather excluded)"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops}


def phase_end_to_end(dev):
    """Serve the synthetic trace through ServingEngine; returns the
    kernels' launch counts over that run and the run's numbers."""
    from apex_tpu_torch.ops import attention_cuda, decode_attention_cuda
    from apex_tpu_torch.serving import (Request, ServingEngine,
                                        lifecycle, synthetic_trace)
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**MODEL)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, seed=0, device=dev, **ENGINE)
    torch.cuda.synchronize()
    _log(f"engine built in {time.perf_counter() - t0:.2f} s")
    # warm-up (cuBLAS handles, allocator) on requests outside the trace
    engine.run_trace([Request(rid=10**6, prompt=[7] * 300, max_new_tokens=3),
                      Request(rid=10**6 + 1, prompt=[9] * 40,
                              max_new_tokens=3)])

    reqs, trace_id = synthetic_trace(vocab=cfg.vocab_size, **TRACE)
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    base = (engine.prefill_batches, engine.decode_steps,
            engine.tokens_generated, engine.tick)
    attention_cuda.prefill_attention.launches = 0
    decode_attention_cuda.decode_attention.launches = 0
    decode_round_s = []
    settled = len(engine.scheduler.completed)
    t0 = time.perf_counter()
    while len(engine.scheduler.completed) - settled < len(reqs):
        if engine.tick - base[3] > 5000:
            raise AssertionError("trace did not drain")
        due = [r for r in pending if r.arrival <= engine.tick - base[3]]
        pending = pending[len(due):]
        r0 = time.perf_counter()
        res = engine.step(arrivals=due)
        if not res["prefilled"] and res["decoded_slots"]:
            decode_round_s.append(time.perf_counter() - r0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = attention_cuda.prefill_attention.launches
    k2 = decode_attention_cuda.decode_attention.launches
    prefills = engine.prefill_batches - base[0]
    decodes = engine.decode_steps - base[1]
    tokens = engine.tokens_generated - base[2]

    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                isinstance(t, int) and 0 <= t < cfg.vocab_size
                for t in r.out_tokens):
            raise AssertionError(f"request {r.rid} did not complete with "
                                 f"{r.max_new_tokens} in-vocab tokens")
    problems = engine.events.validate_order()
    if problems:
        raise AssertionError(f"lifecycle order: {problems[:5]}")
    if k1 != prefills * cfg.num_layers or k2 != decodes * cfg.num_layers:
        raise AssertionError(
            f"launch counts {k1}/{k2} != prefill_batches {prefills} x "
            f"{cfg.num_layers} / decode_steps {decodes} x "
            f"{cfg.num_layers}")
    lat = lifecycle.request_latencies(reqs)
    ttft = [x["ttft_s"] * 1e3 for x in lat if x["ttft_s"] is not None]
    tpot = [x["tpot_s"] * 1e3 for x in lat if x["tpot_s"] is not None]
    stats = {
        "trace_id": trace_id, "requests": len(reqs), "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_batches": prefills, "decode_steps": decodes,
        "decode_round_ms_mean": (1e3 * sum(decode_round_s)
                                 / max(len(decode_round_s), 1)),
        "ttft_p50_ms": lifecycle.percentile(ttft, 50),
        "ttft_p99_ms": lifecycle.percentile(ttft, 99),
        "tpot_p50_ms": lifecycle.percentile(tpot, 50),
        "device_dispatch_s": engine.device_dispatch_s,
    }
    _log("end to end: " + json.dumps(stats))
    return engine, {"prefill_attention": k1, "decode_attention": k2}


def phase_device_share(engine):
    """Replay a second, short trace under torch.profiler: the device's
    busy share of that window and its kernel time by kind (the profiler
    adds host cost, so this window's wall is not a throughput number)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import synthetic_trace

    reqs, _ = synthetic_trace(seed=1, n_requests=8, vocab=MODEL["vocab_size"],
                              prompt_lo=16, prompt_hi=64, new_lo=32,
                              new_hi=32, mean_interarrival=0.0)
    for r in reqs:
        r.rid += 2000     # rids stay unique in the engine's event log
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_trace(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {"prefill_attention": 0.0, "decode_attention": 0.0,
             "matmul": 0.0, "other": 0.0}
    by_name = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.is_user_annotation:
            continue
        name = evt.key
        kind = ("prefill_attention" if "prefill_attention_kernel" in name
                else "decode_attention" if "decode_attention_kernel" in name
                else "matmul" if any(w in name.lower() for w in
                                     ("gemm", "gemv", "cutlass", "xmma",
                                      "nvjet", "sm90_"))
                else "other")
        kinds[kind] += evt.self_device_time_total
        by_name.append((evt.self_device_time_total, evt.count, name[:60]))
    busy = sum(kinds.values())
    if busy == 0:
        _log("device busy share: not measured (the profiler saw no "
             "device time)")
        return None
    share = {"window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
             "device_busy_share": busy / wall_us}
    share.update({f"{k}_ms": v / 1e3 for k, v in kinds.items()})
    _log("profiled window: " + json.dumps(share))
    for us, count, name in sorted(by_name, reverse=True)[:8]:
        _log(f"  {us / 1e3:8.3f} ms  {count:6d} x  {name}")
    return share


def phase_paths_agree(engine, dev):
    """One packed prefill batch + 4 decode steps through the kernel path
    and the plain path on the card; logits within the bf16 band."""
    from apex_tpu_torch.ops import attention, decode_attention
    from apex_tpu_torch.serving import init_cache
    from apex_tpu_torch.serving import model as smodel

    cfg = engine.cfg
    S, ps, maxp, slots = 512, 128, 8, 8
    gen = torch.Generator().manual_seed(4)
    lens = (200, 150, 100)
    ids = torch.zeros(S, dtype=torch.int64)
    pos = torch.zeros(S, dtype=torch.int64)
    seg = torch.zeros(S, dtype=torch.int32)
    rows = torch.full((S,), slots, dtype=torch.int64)
    pt = torch.zeros(slots + 1, maxp, dtype=torch.int32)
    cur = 0
    for r, n in enumerate(lens):
        ids[cur:cur + n] = torch.randint(0, cfg.vocab_size, (n,),
                                         generator=gen)
        pos[cur:cur + n] = torch.arange(n)
        seg[cur:cur + n] = r + 1
        rows[cur:cur + n] = r
        pt[r, :2] = torch.tensor([1 + 2 * r, 2 + 2 * r])
        cur += n
    last = torch.tensor([lens[0] - 1, lens[0] + lens[1] - 1, cur - 1],
                        dtype=torch.int64)
    args = [x.to(dev) for x in (ids, pos, seg, rows, pt, last)]

    def plain_fused(q, k, v, *, causal, sm_scale, segment_ids):
        return attention._dense_attention(q, k, v, causal, sm_scale,
                                          segment_ids)

    def plain_decode(q, kp, vp, page_table, lengths, *, sm_scale):
        return decode_attention.decode_attention_reference(
            q, kp, vp, page_table, lengths, sm_scale)

    def run(tokens_fed):
        cache = init_cache(cfg.num_layers, cfg.num_attention_heads, 72, ps,
                           cfg.head_dim, torch.bfloat16, device=dev)
        cache, logits = smodel.prefill(engine.params, cache, *args, cfg=cfg)
        out = [logits.float()]
        lengths = torch.tensor(list(lens) + [0] * (slots - len(lens)),
                               device=dev)
        for step in range(4):
            lengths = lengths + (lengths > 0)
            toks = tokens_fed[step]
            cache, _, lg = smodel.decode_step(
                engine.params, cache, toks, lengths, args[4][:slots],
                cfg=cfg)
            out.append(lg.float())
        return out

    # the kernel path picks the tokens; both paths are fed the same ones
    fed = [torch.randint(0, cfg.vocab_size, (slots,), generator=gen)
           .to(dev) for _ in range(4)]
    kernel_logits = run(fed)
    with mock.patch.object(smodel, "fused_attention", plain_fused), \
            mock.patch.object(smodel, "decode_attention", plain_decode):
        plain_logits = run(fed)
    worst, agree, total = 0.0, 0, 0
    for a, b in zip(kernel_logits, plain_logits):
        live = slice(0, len(lens))
        worst = max(worst, (a[live] - b[live]).abs().max().item())
        agree += int((a[live].argmax(-1) == b[live].argmax(-1)).sum())
        total += len(lens)
    _log(f"kernel vs plain path on the card: max |logit diff| {worst:.4f} "
         f"(band {LOGITS_BAND}), argmax agreement {agree}/{total}")
    if not worst <= LOGITS_BAND:
        raise AssertionError(f"kernel path logits off by {worst}")
    return worst, agree / total


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false — this "
                 "smoke needs a CUDA card")
    from apex_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}; allow_tf32 matmul/cudnn "
         f"False/False")
    dev = torch.device("cuda")

    build_s = _build.build()
    _log(f"build: {build_s:.1f} s for {len(_build.SOURCES)} kernels")
    for name in _build.SOURCES:
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = [phase_prefill_kernel(dev, flush), phase_decode_kernel(dev, flush)]
    del flush
    engine, launches = phase_end_to_end(dev)
    phase_paths_agree(engine, dev)
    phase_device_share(engine)

    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never ran on the main path")
        row["card"] = smi
        _log(json.dumps(row))
    _log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
