"""Each body of K10L (the long-row softmax forward, ``csrc/softmax.cu``)
forced at row lengths around the edges of ``softmax_cuda.long_plan``, on
the card: every body that can take a length, held against the plain
version within the card tests' band, then timed (CUDA events over 20
launches, each after a 128 MB L2 flush) in turns, the plan's choice
first and last. These are the numbers the plan's edges were set from.
Needs a CUDA card:

    python3 tests/port/long_softmax_bodies.py

One JSON line per (length, dtype, mask) with each body's mean ms, the
plan's choice and the fastest body.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from apex_tpu_torch.ops import _build, softmax, softmax_cuda  # noqa: E402

# (length, leading dims of the scores, causal); fp32 runs on half the rows
CASES = [(5000, (1, 12, 1024), False), (8192, (1, 12, 1024), False),
         (8192, (1, 12, 1024), True), (16384, (1, 12, 512), False),
         (24576, (1, 12, 256), False), (32768, (1, 12, 256), False),
         (49152, (1, 12, 256), False), (98304, (1, 1, 1024), False)]
# the card tests' bands: the largest |y diff|
Y_TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-6}


def _time_ms(fn, flush, reps=20):
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


def _candidates(sk, itemsize):
    """The plans that can take a row: the register body (bf16/fp16) on
    the fewest warps (up to 512 threads), the smem body at 256 and 512
    threads where its stage fits, the walking body at 256 and 512
    threads."""
    nvec = -(-sk // (16 // itemsize))
    per_thread = softmax_cuda.LONG_REG_VALUES * itemsize // 16
    out = []
    regs = 32 * -(-nvec // (32 * per_thread))
    if itemsize == 2 and regs <= softmax_cuda.LONG_MAX_THREADS:
        out.append(softmax_cuda.LongPlan("regs", regs, 0))
    stage = -(-(nvec * 17) // 16) * 16
    if stage <= softmax_cuda.LONG_SMEM_MAX:
        out += [softmax_cuda.LongPlan("smem", t, stage) for t in (256, 512)]
    out += [softmax_cuda.LongPlan("walk", t, 0) for t in (256, 512)]
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("long_softmax_bodies: needs a CUDA card")
    dev = torch.device("cuda")
    _build.build(("softmax",))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for sk, lead, causal in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            shape = lead if dtype == torch.bfloat16 else (
                *lead[:2], max(1, lead[2] // 2))
            gen = torch.Generator(device=dev).manual_seed(sk)
            x = (torch.randn(*shape, sk, generator=gen, device=dev)
                 * 3).to(dtype)
            ry = softmax.scaled_masked_softmax_reference(x, None, 2.0,
                                                         causal)
            chosen = softmax_cuda.long_plan(sk, x.element_size())
            plans = [chosen] + [p for p in _candidates(sk, x.element_size())
                                if p != chosen]
            runs = []
            for p in plans:
                def run(p=p):
                    with mock.patch.object(softmax_cuda, "long_plan",
                                           lambda *_: p):
                        return softmax_cuda.softmax_fwd_long(x, None, 2.0,
                                                             causal)
                err = (run().float() - ry.float()).abs().max().item()
                if err > Y_TOL[dtype]:
                    raise AssertionError(f"{p} at {sk} keys ({dtype}): "
                                         f"max |y diff| {err}")
                runs.append((p, run))
            times = {p: [] for p, _ in runs}
            for p, run in runs + runs[::-1]:
                times[p].append(_time_ms(run, flush))
            ms = {f"{p.body}{p.threads}": sum(t) / 2 for p, t in times.items()}
            print(json.dumps({
                "keys": sk, "shape": [*shape, sk],
                "dtype": str(dtype).split(".")[-1], "causal": causal,
                "plan": f"{chosen.body}{chosen.threads}",
                "fastest": min(ms, key=ms.get), "ms": ms}), flush=True)
            del x, ry
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
