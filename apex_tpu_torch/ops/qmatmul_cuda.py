"""Wrapper of the hand-written W8A16 decode matmul (``csrc/qmatmul.cu``):
K23 :func:`qmatmul`. It replaces no Pallas site: the JAX package
contracts the int8 weight in XLA (``apex_tpu/serving/quant.py:77``); the
source's header says what bounds it (bytes) and how the design answers
that. :func:`plan` picks the launch: the tensor-core body for bf16 and
fp16 x, with its n-tiles and its split of K over a block's warps and a
cluster's blocks, in its 16-byte-load form where K is a multiple of 16
and its element-load form at any other K; or the CUDA-core body for fp32
x, which takes any K.

The wrapper checks its inputs and the plan and raises on anything the
kernel does not take, allocates the output, launches on PyTorch's
current stream without synchronising, raises on a refused launch, and
counts each launch in ``qmatmul.launches`` (a plain int; a caller resets
it to 0 before the run it wants to read). The plain version is
``ops/qmatmul.qmatmul_reference``.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from apex_tpu_torch.ops import _build

_NAME = "qmatmul"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "qmatmul_w8a16": ([_P, _P, _P, _P] + [_I] * 10 + [_P], _I),
    "qmatmul_error_string": ([_I], ctypes.c_char_p),
}
# csrc/qmatmul.cu's constants
STEP = 16         # one mma's k; the 16-byte-load body takes K a multiple
CHUNK = 64        # K columns a chunk of the tensor-core body
TILE_N = 16       # output channels a warp (tc) / a block (simt)
TILE_B = 8        # x rows an n-tile (tc) / a block (simt)
MAX_NT = 4        # n-tiles a warp
SPLITS = (1, 2, 4)
MAX_CLUSTER = 8
MAX_GRID_YZ = 65535
MAX_ROWS = MAX_GRID_YZ * TILE_B
BODIES = {"tc": 0, "simt": 1, "tc_narrow": 2}
# warps a plan aims to have on each SM: enough that a layer matrix of a few
# MB is in flight at once (csrc/qmatmul.cu's header says how it was set)
WARPS_PER_SM = 8


def max_depth(nt):
    """The most chunks a lane of the tensor-core body keeps in flight at
    ``nt`` n-tiles (its instantiations: 4 at 1-2, 2 at 3-4)."""
    return 4 if nt <= 2 else 2


class Plan(NamedTuple):
    """A launch of K23: ``body`` "tc" (bf16/fp16 x, 16-byte loads: K a
    multiple of 16, x and wq 16-byte aligned), "tc_narrow" (the same body
    at any K, by element loads) or "simt" (fp32 x, any K);
    for tc, ``nt`` n-tiles of 8 x rows a warp, ``split`` pieces of K a
    block (a block then takes ``4 // split`` channel tiles),
    ``cluster`` blocks a cluster, each with ``split`` more pieces, and
    ``depth`` chunks of weights and x a lane keeps in flight (2, or 4 at
    1-2 n-tiles); simt is 1, 1, 1, 1 (it loads one chunk ahead)."""
    body: str
    nt: int = 1
    split: int = 1
    cluster: int = 1
    depth: int = 1


def plan(B, N, K, dtype, sm_count, aligned=True):
    """The launch of K23 for ``x [B, K] @ wq [N, K]^T`` on a card of
    ``sm_count`` SMs. fp32 x takes the CUDA-core body (the tensor cores
    would round x to TF32). bf16 and fp16 take the tensor-core body:
    ``nt`` the fewest n-tiles that hold B rows (at most 4, then groups of
    32 rows). Where the channel tiles alone give fewer than
    ``WARPS_PER_SM`` warps an SM, K is split over a block's warps (up to 4
    pieces, at most one a 64-column chunk), and over a cluster's blocks
    only as far as that leaves each warp no more chunks than it can keep in
    flight: on an H100 a cluster's launch and combine cost more than they
    save at GPT-2-small's K = 768 (they pay at its 3072). Where the tiles
    fill the card (the logits), one piece a tile. ``depth`` 4 where a
    warp's piece fits in it, else 2 (fewer registers, more blocks an SM:
    the logits' 786 blocks then fit the card at once). The body loads 16
    bytes at a time where K is a multiple of 16 and ``wq`` is 16-byte
    ``aligned`` ("tc"), else one element at a time ("tc_narrow")."""
    if dtype == torch.float32:
        return Plan("simt")
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"qmatmul: dtype {dtype} (want bf16/fp16/fp32)")
    nt = min(MAX_NT, -(-B // TILE_B))
    units = -(-N // TILE_N) * -(-B // (TILE_B * nt))
    chunks = max(1, K // CHUNK)
    want = -(-WARPS_PER_SM * sm_count // units)
    split = max(s for s in SPLITS if s <= min(want, chunks))
    cluster = min(MAX_CLUSTER, -(-want // split), chunks // split,
                  -(-chunks // (split * max_depth(nt))))
    per_warp = -(-chunks // (split * cluster))
    depth = 4 if max_depth(nt) == 4 and per_warp <= 4 else 2
    body = "tc" if aligned and K % STEP == 0 else "tc_narrow"
    return Plan(body, nt, split, cluster, depth)


def check_plan(p, B, K, dtype, x_ptr=0, wq_ptr=0):
    """Raise ``ValueError`` on a plan the C entry refuses (its
    ``plan_ok``)."""
    if p.body in ("tc", "tc_narrow"):
        wide_ok = K % STEP == 0 and x_ptr % 16 == 0 and wq_ptr % 16 == 0
        ok = (dtype in (torch.bfloat16, torch.float16)
              and (p.body == "tc_narrow" or wide_ok)
              and 1 <= p.nt <= MAX_NT and p.split in SPLITS
              and 1 <= p.cluster <= MAX_CLUSTER
              and p.split * p.cluster <= max(1, K // CHUNK)
              and p.depth in (2, max_depth(p.nt))
              and -(-B // (TILE_B * p.nt)) <= MAX_GRID_YZ)
    else:
        ok = (p.body == "simt" and dtype == torch.float32
              and (p.nt, p.split, p.cluster, p.depth) == (1, 1, 1, 1)
              and -(-B // TILE_B) <= MAX_GRID_YZ)
    if not ok:
        raise ValueError(f"qmatmul: the kernel does not take {p} for x "
                         f"[{B}, {K}] {dtype}")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def qmatmul(x, wq, scale):
    """K23: ``y [B, N] = (x [B, K] @ wq [N, K]^T) * scale [N]`` in
    ``x``'s dtype (bf16, fp16 or fp32), accumulated in fp32, the scale on
    the fp32 output columns, one rounding. ``wq`` int8 at any K,
    ``scale`` fp32; all contiguous on one CUDA device, on the launch
    :func:`plan` picks."""
    name = "qmatmul"
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name}: want x [B, K], wq [N, K], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(scale.shape)}")
    dev = x.device
    (B, K), N = x.shape, wq.shape[0]
    for what, t, dtypes in (("x", x, tuple(_build.DTYPE_CODES)),
                            ("wq", wq, (torch.int8,)),
                            ("scale", scale, (torch.float32,))):
        if not t.is_cuda or t.device != dev or not t.is_contiguous() \
                or t.dtype not in dtypes:
            raise ValueError(f"{name}: want {what} a contiguous tensor of "
                             f"{dtypes} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if wq.shape[1] != K or scale.shape[0] != N:
        raise ValueError(f"{name}: x {tuple(x.shape)}, wq {tuple(wq.shape)} "
                         f"and scale {tuple(scale.shape)} do not agree")
    if not 0 < B <= MAX_ROWS or N < 1 or K < 1:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_ROWS} rows, "
                         f"N and K at least 1; got B {B}, N {N}, K {K}")
    p = plan(B, N, K, x.dtype, _sm_count(dev.index), wq.data_ptr() % 16 == 0)
    if p.body == "tc" and x.data_ptr() % 16:
        x = x.clone()     # the 16-byte-load body reads x in 16-byte vectors
    check_plan(p, B, K, x.dtype, x.data_ptr(), wq.data_ptr())
    y = torch.empty((B, N), dtype=x.dtype, device=dev)
    _build.launch(_NAME, _SIGNATURES, "qmatmul_w8a16", dev, x.data_ptr(),
                  wq.data_ptr(), scale.data_ptr(), y.data_ptr(), B, N, K,
                  _build.DTYPE_CODES[x.dtype], BODIES[p.body], p.nt, p.split,
                  p.cluster, p.depth)
    qmatmul.launches += 1
    return y


qmatmul.launches = 0
