"""Wrappers of the hand-written CUDA batch-norm kernels
(``csrc/batch_norm.cu``): K17 :func:`fwd_stats` and :func:`fwd_apply`
(the forward's two stages), K18 :func:`bwd_stats` and :func:`bwd_apply`
(the backward's). They replace no Pallas site: the JAX package computes
``apex_tpu/parallel/sync_batchnorm.py:23 sync_batch_norm`` in jnp; they
are the port's counterpart of apex's syncbn extension. The source's
header says what bounds them (bytes) and how the design answers that.

Each takes contiguous ``[M, C]`` rows (channels innermost) in bf16, fp16
or fp32, per-channel scale and bias in any of those dtypes (or None),
fp32 running stats, and raises on anything else; allocates its outputs;
launches on PyTorch's current stream without synchronising; raises on a
refused launch; and counts each launch in ``<wrapper>.launches`` (a
plain int; a caller resets it to 0 before the run it wants to read). The
plain versions are ``ops/batch_norm.*_reference``. The stats stages keep
one ticket array per (device, stream) that their last block resets.
"""

import ctypes
from collections import namedtuple

import numpy as np
import torch

from apex_tpu_torch.ops import _build

_NAME = "batch_norm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = ([_P, _P, _P, _P], _I)
_SIGNATURES = {
    "bn_fwd_stats": _ENTRY,
    "bn_fwd_apply": _ENTRY,
    "bn_bwd_stats": _ENTRY,
    "bn_bwd_apply": _ENTRY,
    "batch_norm_error_string": ([_I], ctypes.c_char_p),
}
THREADS = 512            # csrc/batch_norm.cu THREADS
BLOCKS_PER_SM = 2048 // THREADS
MAX_TILES = 65535
_tickets = {}            # (device index, stream) -> int32 [MAX_TILES]
_sm_count = {}

Plan = namedtuple("Plan", "vec tx slabs rows_per_slab tiles")


def plan(rows, channels, dtype, sm_count, aligned=True):
    """The launch of one stage: 16-byte vectors of channels where the row
    width and the pointer allow (``vec`` 8 bf16/fp16, 4 fp32; else 1),
    ``tx`` lanes over vectors (up to 32) and 512 / tx over rows, ``tiles``
    of tx vectors, and slabs of rows so that slabs x tiles fills one wave
    (``BLOCKS_PER_SM`` blocks an SM)."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size
    if not aligned or channels % vec:
        vec = 1
    cvec = channels // vec
    tx = min(cvec, 32)
    ty = THREADS // tx
    tiles = -(-cvec // tx)
    want = max(1, (sm_count * BLOCKS_PER_SM) // tiles)
    slabs = max(1, min(-(-rows // ty), want))
    rows_per_slab = -(-rows // slabs)
    slabs = -(-rows // rows_per_slab)
    return Plan(vec, tx, slabs, rows_per_slab, tiles)


def _sms(dev):
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_count[dev.index]


def _tickets_for(dev):
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(MAX_TILES, dtype=torch.int32, device=dev)
    return _tickets[key]


def _rows(name, x2d, *others):
    if not x2d.is_cuda or x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"{name}: want contiguous [M, C] CUDA rows, got "
                         f"{tuple(x2d.shape)} on {x2d.device} (contiguous "
                         f"{x2d.is_contiguous()})")
    if x2d.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x2d.dtype} (want bf16/fp16/fp32)")
    if x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError(f"{name}: empty rows {tuple(x2d.shape)}")
    for t in others:
        if t.shape != x2d.shape or t.dtype != x2d.dtype \
                or t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} beside "
                             f"{tuple(x2d.shape)} {x2d.dtype}")
    dev = x2d.device
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2d,) + others)
    return dev, plan(x2d.shape[0], x2d.shape[1], x2d.dtype, _sms(dev),
                     aligned)


def _channel(name, t, c, dev, fp32=False, what="a parameter"):
    """The address of a per-channel tensor (0 for None) and its code."""
    if t is None:
        return 0, 0
    if t.shape != (c,) or t.device != dev or not t.is_contiguous() \
            or t.dtype not in _build.DTYPE_CODES \
            or (fp32 and t.dtype != torch.float32):
        raise ValueError(f"{name}: {what} must be a contiguous [{c}] "
                         f"{'fp32' if fp32 else 'float'} tensor on {dev}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.data_ptr(), _build.DTYPE_CODES[t.dtype]


def _launch(fn_name, dev, x2d, p, ptrs, hyper=(0.0, 0.0, 1.0), codes=(0, 0),
            training=1, fuse_relu=0):
    dims = np.array([x2d.shape[0], x2d.shape[1], p.vec, p.tx, p.slabs,
                     p.rows_per_slab], dtype=np.int64)
    ptr_arr = np.array([ptrs.get(k, 0) for k in (
        "x", "dy", "out", "partials", "stats", "sums", "tickets", "w", "b",
        "rmean", "rvar", "mean", "rstd")], dtype=np.int64)
    hyp = np.array(hyper, dtype=np.float32)
    flags = np.array([_build.DTYPE_CODES[x2d.dtype], codes[0], codes[1],
                      int(bool(training)), int(bool(fuse_relu))],
                     dtype=np.int32)
    _build.launch(_NAME, _SIGNATURES, fn_name, dev, dims.ctypes.data,
                  ptr_arr.ctypes.data, hyp.ctypes.data, flags.ctypes.data)


def fwd_stats(x2d):
    """K17 stage 1: ``[sum x, sum x^2, n]`` (fp32 ``[2C + 1]``) of the
    rows, in a fixed order (two runs give the same bits)."""
    dev, p = _rows("batch_norm fwd_stats", x2d)
    c = x2d.shape[1]
    partials = torch.empty(p.slabs * 2 * c, dtype=torch.float32, device=dev)
    stats = torch.empty(2 * c + 1, dtype=torch.float32, device=dev)
    _launch("bn_fwd_stats", dev, x2d, p, {
        "x": x2d.data_ptr(), "partials": partials.data_ptr(),
        "stats": stats.data_ptr(), "tickets": _tickets_for(dev).data_ptr()})
    fwd_stats.launches += 1
    return stats


def fwd_apply(x2d, stats, weight, bias, running_mean, running_var, eps,
              momentum, training, fuse_relu):
    """K17 stage 2: ``(y, mean, rstd)`` from ``stats`` in training (the
    running stats, fp32 or None, updated in place) or from the running
    stats in eval; y = ((x - mean) rstd) scale + bias, ReLU with
    ``fuse_relu``, in x's dtype."""
    name = "batch_norm fwd_apply"
    dev, p = _rows(name, x2d)
    c = x2d.shape[1]
    if (running_mean is None) != (running_var is None):
        raise ValueError(f"{name}: both running stats or neither")
    if training and (stats is None or stats.shape != (2 * c + 1,)
                     or stats.dtype != torch.float32 or stats.device != dev):
        raise ValueError(f"{name}: training needs the fp32 [2C + 1] stats")
    if not training and running_mean is None:
        raise ValueError(f"{name}: eval needs the running stats")
    wptr, wcode = _channel(name, weight, c, dev)
    bptr, bcode = _channel(name, bias, c, dev)
    rmptr, _ = _channel(name, running_mean, c, dev, True, "running_mean")
    rvptr, _ = _channel(name, running_var, c, dev, True, "running_var")
    y = torch.empty_like(x2d)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    rstd = torch.empty(c, dtype=torch.float32, device=dev)
    _launch("bn_fwd_apply", dev, x2d, p, {
        "x": x2d.data_ptr(), "out": y.data_ptr(),
        "stats": stats.data_ptr() if training else 0, "w": wptr, "b": bptr,
        "rmean": rmptr, "rvar": rvptr, "mean": mean.data_ptr(),
        "rstd": rstd.data_ptr()}, (eps, momentum, 1 - momentum),
        (wcode, bcode), training, fuse_relu)
    fwd_apply.launches += 1
    return y, mean, rstd


def _saved(name, mean, rstd, c, dev):
    for t, what in ((mean, "mean"), (rstd, "rstd")):
        _channel(name, t, c, dev, True, what)


def bwd_stats(x2d, dy2d, mean, rstd, weight, bias, fuse_relu):
    """K18 stage 1: ``[sum g, sum g xhat]`` (fp32 ``[2C]``), g the output
    gradient masked where the fused ReLU's output is not positive."""
    name = "batch_norm bwd_stats"
    dev, p = _rows(name, x2d, dy2d)
    c = x2d.shape[1]
    _saved(name, mean, rstd, c, dev)
    wptr, wcode = _channel(name, weight, c, dev)
    bptr, bcode = _channel(name, bias, c, dev)
    partials = torch.empty(p.slabs * 2 * c, dtype=torch.float32, device=dev)
    sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
    _launch("bn_bwd_stats", dev, x2d, p, {
        "x": x2d.data_ptr(), "dy": dy2d.data_ptr(),
        "partials": partials.data_ptr(), "sums": sums.data_ptr(),
        "tickets": _tickets_for(dev).data_ptr(), "w": wptr, "b": bptr,
        "mean": mean.data_ptr(), "rstd": rstd.data_ptr()},
        codes=(wcode, bcode), fuse_relu=fuse_relu)
    bwd_stats.launches += 1
    return sums


def bwd_apply(x2d, dy2d, mean, rstd, weight, bias, sums, stats, training,
              fuse_relu):
    """K18 stage 2: dx in x's dtype from the (all-reduced) ``sums`` and the
    forward's ``stats`` (its count, ``stats[2C]``) in training; scale rstd g
    in eval."""
    name = "batch_norm bwd_apply"
    dev, p = _rows(name, x2d, dy2d)
    c = x2d.shape[1]
    _saved(name, mean, rstd, c, dev)
    if training and (sums is None or sums.shape != (2 * c,)
                     or stats is None or stats.shape != (2 * c + 1,)):
        raise ValueError(f"{name}: training needs the [2C] sums and the "
                         f"[2C + 1] stats")
    wptr, wcode = _channel(name, weight, c, dev)
    bptr, bcode = _channel(name, bias, c, dev)
    dx = torch.empty_like(x2d)
    _launch("bn_bwd_apply", dev, x2d, p, {
        "x": x2d.data_ptr(), "dy": dy2d.data_ptr(), "out": dx.data_ptr(),
        "sums": sums.data_ptr() if training else 0,
        "stats": stats.data_ptr() if training else 0, "w": wptr, "b": bptr,
        "mean": mean.data_ptr(), "rstd": rstd.data_ptr()},
        codes=(wcode, bcode), training=training, fuse_relu=fuse_relu)
    bwd_apply.launches += 1
    return dx


fwd_stats.launches = 0
fwd_apply.launches = 0
bwd_stats.launches = 0
bwd_apply.launches = 0
