"""What the serving engine's dispatch watchdog (``recover=True``) costs on
the card, and why it keeps one worker thread: a bare loop of a tiny
dispatch (a kernel and its fetch) run inline, on a new thread a call
(``serving.resilience.guarded_dispatch``, JAX's design) and on a reused
worker (``serving.resilience.Watchdog``, the engine's); then ``TRACE``
served at GPT-2-small's width (``chip_smoke.MODEL``, ``LAYER_ENGINE``,
bf16, graphed) with the watchdog off, on a new thread a dispatch and on
the reused worker, in turns (off, thread, reused, reused, thread, off),
the tokens equal bit for bit. Needs a CUDA card:

    python3 tests/port/watchdog_cost.py

Prints the card, one JSON line of microseconds a call for the loop, and
one of tokens/s, decode-round ms, TTFT and TPOT p50 by mode (the mean of
its turns).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
from apex_tpu_torch.ops import _build  # noqa: E402
from apex_tpu_torch.serving import resilience as serve_res  # noqa: E402

MODES = ("off", "thread", "reused", "reused", "thread", "off")


class _ThreadACall:
    """A watchdog that starts a thread for every dispatch."""

    @staticmethod
    def run(fn, timeout_s, phase):
        return serve_res.guarded_dispatch(fn, timeout_s, phase)


def bare_loop(dev, n=2000):
    x = torch.zeros(8, device=dev)
    stream = torch.cuda.current_stream()
    reused = serve_res.Watchdog()

    def work():
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            return (x + 1).cpu()

    out = {}
    for name, run in (("inline", work),
                      ("thread", lambda: serve_res.guarded_dispatch(
                          work, 60, "decode")),
                      ("reused", lambda: reused.run(work, 60, "decode"))):
        for _ in range(50):
            run()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("watchdog_cost: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("prefill_attention", "decode_attention"))
    dev = torch.device("cuda")
    print(json.dumps({"bare_loop_us": bare_loop(dev)}), flush=True)
    from apex_tpu_torch.serving import init_gpt_params, synthetic_trace
    from apex_tpu_torch.transformer.testing import TransformerConfig

    cfg = TransformerConfig(**cs.MODEL)
    params = init_gpt_params(cfg, 0, dev)
    runs, tokens = {}, {}
    for mode in MODES:
        engine = cs._layer_engine(cfg, params, dev, recover=mode != "off",
                                  dispatch_timeout_s=60)
        if mode == "thread":
            engine._watchdog = _ThreadACall()
        reqs, _ = synthetic_trace(vocab=cfg.vocab_size, **cs.TRACE)
        toks, stats = cs._layer_run(engine, reqs)
        if tokens.setdefault("first", toks) != toks:
            raise AssertionError(f"{mode}: the tokens differ")
        runs.setdefault(mode, []).append(stats)
        del engine
        torch.cuda.empty_cache()
    print(json.dumps({
        mode: {m: statistics.mean(t[m] for t in turns)
               for m in ("tokens_per_s", "decode_round_ms", "ttft_p50_ms",
                         "tpot_p50_ms")}
        for mode, turns in runs.items()}), flush=True)


if __name__ == "__main__":
    main()
