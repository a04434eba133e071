"""Wrappers of the hand-written CUDA layer-norm kernels
(``csrc/layer_norm.cu``): K3 :func:`layer_norm_fwd` replaces
``apex_tpu/ops/layer_norm_pallas.py:171 _fwd`` and K4
:func:`layer_norm_bwd` replaces ``:215 _bwd_rule``. The source's header
says what bounds them (bandwidth) and how the design answers that. They
take rows of any width; :func:`plan` picks the body, the vector width,
the lanes or threads a row and the grid, and the C entries take that
plan as arguments.

Each wrapper checks its inputs, allocates its outputs, launches on
PyTorch's current stream without synchronising, raises on a refused
launch, and counts the launch in ``<wrapper>.launches`` (a plain int; a
caller resets it to 0 before the run it wants to read). The plain
versions are in :mod:`apex_tpu_torch.ops.layer_norm`.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from apex_tpu_torch.ops import _build

_NAME = "layer_norm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "layer_norm_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I,
                        _I, _I, _P], _I),
    "layer_norm_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P], _I),
    "layer_norm_error_string": ([_I], ctypes.c_char_p),
}

# the bodies of csrc/layer_norm.cu (its enum Body)
BODIES = {"team": 0, "rows": 1, "wide": 2}
ROW_WARPS = 8            # warps a block of the rows body
ROW_MAX_VECS = 128       # vectors a row of the rows body: 32 lanes x 4
TEAM_MAX_HIDDEN = 8192   # the team body's widest row
WIDE_ELEMS = 24          # elements a wide thread keeps in registers
MAX_TEAM_BWD_BLOCKS = 256  # the team body's partial rows

Plan = namedtuple("Plan", "body vec lanes grid")
Plan.__doc__ = """A launch of K3 or K4: ``body`` (a key of ``BODIES``),
``vec`` (elements a load), ``lanes`` (lanes of a warp a row for the rows
body, threads a row for the team and wide bodies) and ``grid`` (blocks; K4
writes one partial row a block)."""


def supported(hidden):
    """Whether the kernels take rows of width ``hidden``: any width of at
    least one column."""
    return hidden >= 1


def vector_width(hidden, itemsize):
    """Elements a load: the widest of 8, 4, 2 and 1 that is at most 16
    bytes and divides ``hidden`` (so that every row starts on a multiple
    of the vector's bytes)."""
    return next(v for v in (8, 4, 2, 1)
                if v * itemsize <= 16 and hidden % v == 0)


def _pow2_at_least(n):
    return 1 << max(0, (n - 1).bit_length())


def _team_tpr(hidden):
    """The team body's threads a row: the smallest team whose G <= 4
    groups of 8 cover the row."""
    return next(t for t in (32, 64, 128, 256) if hidden // 8 <= 4 * t)


@functools.lru_cache(maxsize=256)
def plan(rows, hidden, dtype, sm_count, backward=False):
    """The launch of K3 (or K4 with ``backward``) on ``[rows, hidden]``
    rows of ``dtype`` on a card of ``sm_count`` SMs (the grids are the
    fastest an H100 measured, ``chip_smoke.py``'s layer-norm phase):

    * ``rows`` where a row is at most ``ROW_MAX_VECS`` vectors (1024 bf16
      columns): a team of the fewest lanes (a power of two) whose 4
      vectors each cover the row. K3's grid gives each warp at least two
      rows to walk (so that it has a next row to prefetch) in one to two
      blocks an SM; K4's is one block an SM (fewer partial rows);
    * ``team`` (the parent's body) for the other multiples of 8 up to
      8192: its threads a row and its grid, a block a row group;
    * ``wide`` for the rest: 128 threads a row up to ``128 *
      WIDE_ELEMS`` columns, else 512; K3 (the parent's kernel) a block a
      row over groups of 8, or element by element where the row is not a
      multiple of 8; K4 one block an SM walking the rows.

    Cached: a training step asks for the same few plans every launch.
    """
    itemsize = dtype.itemsize
    vec = vector_width(hidden, itemsize)
    nvec = hidden // vec
    if nvec <= ROW_MAX_VECS:
        lanes = min(32, _pow2_at_least(-(-nvec // 4)))
        per_block = ROW_WARPS * (32 // lanes)
        blocks = -(-rows // per_block)
        if backward:
            return Plan("rows", vec, lanes, min(blocks, sm_count))
        walk = max(sm_count, min(2 * sm_count, -(-blocks // 2)))
        return Plan("rows", vec, lanes, min(blocks, walk))
    if hidden % 8 == 0 and hidden <= TEAM_MAX_HIDDEN:
        tpr = _team_tpr(hidden)
        if backward:
            per_block = -(-rows // MAX_TEAM_BWD_BLOCKS)
            return Plan("team", 8, tpr, -(-rows // per_block))
        return Plan("team", 8, tpr, -(-rows // (256 // tpr)))
    lanes = 128 if hidden <= 128 * WIDE_ELEMS else 512
    if backward:
        return Plan("wide", vec, lanes, min(rows, sm_count))
    return Plan("wide", 8 if hidden % 8 == 0 else 1, lanes, rows)


def plan_alignment(p, itemsize):
    """The bytes a row tensor's start must be a multiple of under plan
    ``p`` (one vector of x's dtype; fp32 groups of 8 load as two 16-byte
    halves), and a weight's (its fp32 vector, in loads of at most 16
    bytes)."""
    return min(16, p.vec * itemsize), min(16, p.vec * 4)


def _check(name, x2d, vectors, row_tensors, p):
    if x2d.dim() != 2 or not x2d.is_cuda:
        raise ValueError(f"{name}: x must be a 2-D CUDA tensor")
    rows, hidden = x2d.shape
    if x2d.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x2d.dtype} (want bf16/fp16/fp32)")
    if not supported(hidden):
        raise ValueError(f"{name}: hidden {hidden} (the kernels take at "
                         f"least one column)")
    if rows < 1:
        raise ValueError(f"{name}: no rows")
    align, w_align = plan_alignment(p, x2d.element_size())
    for tname, t in row_tensors:
        if (t.device != x2d.device or t.dtype != x2d.dtype
                or t.shape != x2d.shape or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{name}: {tname} must be a contiguous "
                             f"{x2d.dtype} {tuple(x2d.shape)} tensor on "
                             f"{x2d.device}, {align}-byte aligned (the "
                             f"{p.body} body's {p.vec}-element vectors)")
    for tname, t, shape, vec in vectors:
        if t is None:
            continue
        a = w_align if vec else 1
        if (t.device != x2d.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % a):
            raise ValueError(f"{name}: {tname} must be a contiguous fp32 "
                             f"{shape} tensor on {x2d.device}, {a}-byte "
                             f"aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(x2d, backward):
    if x2d.dim() != 2 or not x2d.is_cuda:
        return None
    return plan(*x2d.shape, x2d.dtype, _sm_count(x2d.device.index),
                backward)


def layer_norm_fwd(x2d, weight, bias, eps):
    """K3 on a ``[rows, hidden]`` CUDA tensor under :func:`plan`;
    ``weight``/``bias`` are fp32 ``[hidden]`` or None. Returns ``(y,
    mean, rstd)``: y in x's dtype, the statistics fp32 ``[rows]``."""
    rows, hidden = x2d.shape if x2d.dim() == 2 else (0, 0)
    p = _plan_for(x2d, False)
    _check("layer_norm_fwd", x2d,
           [("weight", weight, (hidden,), True),
            ("bias", bias, (hidden,), True)], [("x", x2d)], p)
    y = torch.empty_like(x2d)
    mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    _build.launch(_NAME, _SIGNATURES, "layer_norm_fwd", x2d.device,
                  x2d.data_ptr(),
                  None if weight is None else weight.data_ptr(),
                  None if bias is None else bias.data_ptr(), y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
                  BODIES[p.body], p.vec, p.lanes, p.grid,
                  _build.DTYPE_CODES[x2d.dtype])
    layer_norm_fwd.launches += 1
    return y, mean, rstd


def layer_norm_bwd(x2d, weight, mean, rstd, dy):
    """K4 under :func:`plan`: ``(dx, dw, db)`` with dx in x's dtype and
    the fp32 affine gradients ``[hidden]``: the kernel writes one partial
    row a block into scratch and its second stage sums them over blocks
    in a fixed order, in the same call."""
    rows, hidden = x2d.shape if x2d.dim() == 2 else (0, 0)
    p = _plan_for(x2d, True)
    _check("layer_norm_bwd", x2d,
           [("weight", weight, (hidden,), True),
            ("mean", mean, (rows,), False), ("rstd", rstd, (rows,), False)],
           [("x", x2d), ("dy", dy)], p)
    dx = torch.empty_like(x2d)
    parts = torch.empty(2, p.grid, hidden, dtype=torch.float32,
                        device=x2d.device)
    sums = torch.empty(2, hidden, dtype=torch.float32, device=x2d.device)
    _build.launch(_NAME, _SIGNATURES, "layer_norm_bwd", x2d.device,
                  x2d.data_ptr(),
                  None if weight is None else weight.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                  sums[0].data_ptr(), sums[1].data_ptr(), rows, hidden,
                  BODIES[p.body], p.vec, p.lanes, p.grid,
                  _build.DTYPE_CODES[x2d.dtype])
    layer_norm_bwd.launches += 1
    return dx, sums[0], sums[1]


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0
