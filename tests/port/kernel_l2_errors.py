"""Relative L2 error, ||kernel - plain|| / ||plain||, of every case the
card tests run for K1 (forward), K3/K4 (layer norm) and K5/K6 (attention
backward), per dtype. It prints one line per attention case and the
worst value per kernel and dtype: the numbers ``L2_TOL`` in
``test_torch_kernels_cuda.py`` is set from. Needs a CUDA card:

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
from apex_tpu_torch.ops import layer_norm_cuda  # noqa: E402


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
        for d in (64, 128):
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
        for hidden in (64, 768, 1024, 4096, 8192):
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
    for (kernel, dtype), value in sorted(worst.items()):
        print(f"worst {kernel} {dtype}: {value:.3e}")


if __name__ == "__main__":
    main()
