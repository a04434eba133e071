"""Wrappers of the hand-written CUDA batch-norm kernels
(``csrc/batch_norm.cu``): K17, the forward, in one launch (:func:`fwd`)
or two (:func:`fwd_stats`, then :func:`fwd_apply`), and K18, the
backward, in one (:func:`bwd`) or two (:func:`bwd_stats`, then
:func:`bwd_apply`). The one-launch forms serve a norm on one rank; the
two-launch forms put the all-reduce of a group of ranks between their
stages (``ops/batch_norm.BatchNormFunction`` chooses by the group's size
alone). They replace no Pallas site: the JAX package computes
``apex_tpu/parallel/sync_batchnorm.py:23 sync_batch_norm`` in jnp; they
are the port's counterpart of apex's syncbn extension. The source's
header says what bounds them (bytes) and how the design answers that.

Each takes contiguous ``[M, C]`` rows (channels innermost) in bf16, fp16
or fp32, per-channel scale and bias in any of those dtypes (or None),
fp32 running stats, and raises on anything else; allocates its outputs;
launches on PyTorch's current stream without synchronising; raises on a
refused launch; and counts each launch in ``<wrapper>.launches`` (a
plain int; a caller resets it to 0 before the run it wants to read). The
plain versions are ``ops/batch_norm.*_reference``. The kernels with a
grid-wide barrier launch cooperatively, on the grid :func:`plan` sizes
from the blocks the card holds at once (:func:`resident`).
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
    "bn_fwd": _ENTRY,
    "bn_bwd": _ENTRY,
    "bn_resident": ([_I, _I, _I, _P], _I),
    "batch_norm_error_string": ([_I], ctypes.c_char_p),
}
THREADS = 512            # csrc/batch_norm.cu THREADS
# csrc/batch_norm.cu's kernel kinds (bn_resident)
KINDS = {"bn_fwd_stats": 0, "bn_fwd_apply": 1, "bn_bwd_stats": 2,
         "bn_bwd_apply": 3, "bn_fwd": 4, "bn_bwd": 5}
_resident = {}           # (device index, kind, dtype code, vec) -> blocks/SM
_sm_count = {}

Plan = namedtuple("Plan", "vec tx tiles slabs rows_per_slab grid")


def vec_of(channels, dtype, aligned=True):
    """The channels a lane loads at once: a 16-byte vector (8 bf16/fp16,
    4 fp32) where the row width and the pointers allow, else 1."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return vec if aligned and channels % vec == 0 else 1


def plan(rows, channels, vec, resident):
    """The launch of one kernel on a card that holds ``resident`` of its
    blocks at once: ``tx`` lanes over ``vec``-channel vectors (up to 32)
    and 512 / tx over rows, ``tiles`` of tx vectors, slabs of rows so
    that tiles x slabs items fill the card once (each block one item,
    where the tiles alone do not outnumber the blocks), and a grid of
    ``min(items, resident)`` blocks, each walking its items."""
    cvec = channels // vec
    tx = min(cvec, 32)
    ty = THREADS // tx
    tiles = -(-cvec // tx)
    want = max(1, resident // tiles)
    slabs = max(1, min(-(-rows // ty), want))
    rows_per_slab = -(-rows // slabs)
    slabs = -(-rows // rows_per_slab)
    return Plan(vec, tx, tiles, slabs, rows_per_slab,
                min(tiles * slabs, resident))


def _sms(dev):
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_count[dev.index]


def resident(fn_name, dtype, vec, dev):
    """The blocks of kernel ``fn_name`` (an entry of csrc/batch_norm.cu)
    for ``dtype`` and ``vec`` that the card holds at once: its SMs times
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the built
    kernel."""
    key = (dev.index, KINDS[fn_name], _build.DTYPE_CODES[dtype], vec)
    if key not in _resident:
        out = ctypes.c_int(0)
        _build.launch(_NAME, _SIGNATURES, "bn_resident", dev, key[1],
                      key[2], vec, ctypes.addressof(out))
        if out.value < 1:
            raise RuntimeError(f"batch_norm: {fn_name} fits no block of "
                               f"{THREADS} threads on an SM")
        _resident[key] = out.value
    return _resident[key] * _sms(dev)


def _rows(name, x2d, *others):
    """The device of the rows and the channels a lane loads at once."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2d,) + others)
    return x2d.device, vec_of(x2d.shape[1], x2d.dtype, aligned)


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


def _launch(fn_name, dev, x2d, vec, ptrs, hyper=(0.0, 0.0, 1.0),
            codes=(0, 0), training=1, fuse_relu=0):
    """Launch ``fn_name`` on its plan; returns the plan's partials buffer
    (``[slabs, 2C]`` fp32, for the kernels with a stats stage) through
    ``ptrs["partials"] = True``."""
    rows, c = x2d.shape
    p = plan(rows, c, vec, resident(fn_name, x2d.dtype, vec, dev))
    partials = None
    if ptrs.get("partials"):
        partials = torch.empty(p.slabs * 2 * c, dtype=torch.float32,
                               device=dev)
        ptrs = dict(ptrs, partials=partials.data_ptr())
    dims = np.array([rows, c, p.vec, p.tx, p.slabs, p.rows_per_slab, p.grid],
                    dtype=np.int64)
    ptr_arr = np.array([ptrs.get(k, 0) for k in (
        "x", "dy", "out", "partials", "stats", "sums", "w", "b", "rmean",
        "rvar", "mean", "rstd")], dtype=np.int64)
    hyp = np.array(hyper, dtype=np.float32)
    flags = np.array([_build.DTYPE_CODES[x2d.dtype], codes[0], codes[1],
                      int(bool(training)), int(bool(fuse_relu))],
                     dtype=np.int32)
    _build.launch(_NAME, _SIGNATURES, fn_name, dev, dims.ctypes.data,
                  ptr_arr.ctypes.data, hyp.ctypes.data, flags.ctypes.data)
    return partials


def _fwd_checks(name, x2d, stats, weight, bias, running_mean, running_var,
                training, dev):
    c = x2d.shape[1]
    if (running_mean is None) != (running_var is None):
        raise ValueError(f"{name}: both running stats or neither")
    if training and stats is not None and (
            stats.shape != (2 * c + 1,) or stats.dtype != torch.float32
            or stats.device != dev):
        raise ValueError(f"{name}: training needs the fp32 [2C + 1] stats")
    if not training and running_mean is None:
        raise ValueError(f"{name}: eval needs the running stats")
    wptr, wcode = _channel(name, weight, c, dev)
    bptr, bcode = _channel(name, bias, c, dev)
    rmptr, _ = _channel(name, running_mean, c, dev, True, "running_mean")
    rvptr, _ = _channel(name, running_var, c, dev, True, "running_var")
    return {"w": wptr, "b": bptr, "rmean": rmptr, "rvar": rvptr}, \
        (wcode, bcode)


def fwd_stats(x2d):
    """K17 stage 1 of the two-launch form: ``[sum x, sum x^2, n]`` (fp32
    ``[2C + 1]``) of the rows, in a fixed order (two runs give the same
    bits)."""
    dev, vec = _rows("batch_norm fwd_stats", x2d)
    stats = torch.empty(2 * x2d.shape[1] + 1, dtype=torch.float32,
                        device=dev)
    _launch("bn_fwd_stats", dev, x2d, vec, {
        "x": x2d.data_ptr(), "partials": True, "stats": stats.data_ptr()})
    fwd_stats.launches += 1
    return stats


def fwd_apply(x2d, stats, weight, bias, running_mean, running_var, eps,
              momentum, training, fuse_relu):
    """K17 stage 2: ``(y, mean, rstd)`` from ``stats`` in training (the
    running stats, fp32 or None, updated in place) or from the running
    stats in eval (the whole eval forward); y = ((x - mean) rstd) scale +
    bias, ReLU with ``fuse_relu``, in x's dtype."""
    name = "batch_norm fwd_apply"
    dev, vec = _rows(name, x2d)
    c = x2d.shape[1]
    if training and stats is None:
        raise ValueError(f"{name}: training needs the fp32 [2C + 1] stats")
    ptrs, codes = _fwd_checks(name, x2d, stats, weight, bias, running_mean,
                              running_var, training, dev)
    y = torch.empty_like(x2d)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    rstd = torch.empty(c, dtype=torch.float32, device=dev)
    _launch("bn_fwd_apply", dev, x2d, vec, dict(
        ptrs, x=x2d.data_ptr(), out=y.data_ptr(),
        stats=stats.data_ptr() if training else 0, mean=mean.data_ptr(),
        rstd=rstd.data_ptr()), (eps, momentum, 1 - momentum), codes,
        training, fuse_relu)
    fwd_apply.launches += 1
    return y, mean, rstd


def fwd(x2d, weight, bias, running_mean, running_var, eps, momentum,
        fuse_relu):
    """K17 in one launch (training, one rank): ``(y, mean, rstd, stats)``,
    the stats ``[sum x, sum x^2, n]`` as :func:`fwd_stats` gives them and
    the rest as :func:`fwd_apply` gives them from those stats, the running
    stats (fp32 or None) updated in place."""
    name = "batch_norm fwd"
    dev, vec = _rows(name, x2d)
    c = x2d.shape[1]
    ptrs, codes = _fwd_checks(name, x2d, None, weight, bias, running_mean,
                              running_var, True, dev)
    y = torch.empty_like(x2d)
    stats = torch.empty(2 * c + 1, dtype=torch.float32, device=dev)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    rstd = torch.empty(c, dtype=torch.float32, device=dev)
    _launch("bn_fwd", dev, x2d, vec, dict(
        ptrs, x=x2d.data_ptr(), out=y.data_ptr(), partials=True,
        stats=stats.data_ptr(), mean=mean.data_ptr(), rstd=rstd.data_ptr()),
        (eps, momentum, 1 - momentum), codes, True, fuse_relu)
    fwd.launches += 1
    return y, mean, rstd, stats


def _saved(name, mean, rstd, c, dev):
    for t, what in ((mean, "mean"), (rstd, "rstd")):
        _channel(name, t, c, dev, True, what)


def _bwd_checks(name, x2d, dy2d, mean, rstd, weight, bias):
    dev, vec = _rows(name, x2d, dy2d)
    c = x2d.shape[1]
    _saved(name, mean, rstd, c, dev)
    wptr, wcode = _channel(name, weight, c, dev)
    bptr, bcode = _channel(name, bias, c, dev)
    return dev, vec, {"x": x2d.data_ptr(), "dy": dy2d.data_ptr(), "w": wptr,
                      "b": bptr, "mean": mean.data_ptr(),
                      "rstd": rstd.data_ptr()}, (wcode, bcode)


def _count(name, stats, c):
    if stats is None or stats.shape != (2 * c + 1,) \
            or stats.dtype != torch.float32:
        raise ValueError(f"{name}: training needs the forward's fp32 "
                         f"[2C + 1] stats (their count)")


def bwd_stats(x2d, dy2d, mean, rstd, weight, bias, fuse_relu):
    """K18 stage 1 of the two-launch form: ``[sum g, sum g xhat]`` (fp32
    ``[2C]``), g the output gradient masked where the fused ReLU's output
    is not positive."""
    dev, vec, ptrs, codes = _bwd_checks("batch_norm bwd_stats", x2d, dy2d,
                                        mean, rstd, weight, bias)
    sums = torch.empty(2 * x2d.shape[1], dtype=torch.float32, device=dev)
    _launch("bn_bwd_stats", dev, x2d, vec, dict(
        ptrs, partials=True, sums=sums.data_ptr()), codes=codes,
        fuse_relu=fuse_relu)
    bwd_stats.launches += 1
    return sums


def bwd_apply(x2d, dy2d, mean, rstd, weight, bias, sums, stats, training,
              fuse_relu):
    """K18 stage 2: dx in x's dtype from the (all-reduced) ``sums`` and the
    forward's ``stats`` (its count, ``stats[2C]``) in training; scale rstd g
    in eval."""
    name = "batch_norm bwd_apply"
    dev, vec, ptrs, codes = _bwd_checks(name, x2d, dy2d, mean, rstd, weight,
                                        bias)
    c = x2d.shape[1]
    if training:
        _count(name, stats, c)
        if sums is None or sums.shape != (2 * c,):
            raise ValueError(f"{name}: training needs the [2C] sums")
    dx = torch.empty_like(x2d)
    _launch("bn_bwd_apply", dev, x2d, vec, dict(
        ptrs, out=dx.data_ptr(), sums=sums.data_ptr() if training else 0,
        stats=stats.data_ptr() if training else 0), codes=codes,
        training=training, fuse_relu=fuse_relu)
    bwd_apply.launches += 1
    return dx


def bwd(x2d, dy2d, mean, rstd, weight, bias, stats, training, fuse_relu):
    """K18 in one launch (one rank): ``(dx, sums)``, the sums as
    :func:`bwd_stats` gives them and dx as :func:`bwd_apply` gives it from
    those sums (and, in training, the forward's count ``stats[2C]``)."""
    name = "batch_norm bwd"
    dev, vec, ptrs, codes = _bwd_checks(name, x2d, dy2d, mean, rstd, weight,
                                        bias)
    c = x2d.shape[1]
    if training:
        _count(name, stats, c)
    sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x2d)
    _launch("bn_bwd", dev, x2d, vec, dict(
        ptrs, out=dx.data_ptr(), partials=True, sums=sums.data_ptr(),
        stats=stats.data_ptr() if training else 0), codes=codes,
        training=training, fuse_relu=fuse_relu)
    bwd.launches += 1
    return dx, sums


fwd_stats.launches = 0
fwd_apply.launches = 0
fwd.launches = 0
bwd_stats.launches = 0
bwd_apply.launches = 0
bwd.launches = 0
