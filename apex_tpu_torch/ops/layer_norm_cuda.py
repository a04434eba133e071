"""Wrappers of the hand-written CUDA layer-norm kernels
(``csrc/layer_norm.cu``): K3 :func:`layer_norm_fwd` replaces
``apex_tpu/ops/layer_norm_pallas.py:171 _fwd`` and K4
:func:`layer_norm_bwd` replaces ``:215 _bwd_rule``. The source's header
says what bounds them (bandwidth) and how the design answers that. They
take rows of any width: a multiple of 8 up to 8192 on the team-per-row
body, wider rows and widths that are not a multiple of 8 on the
row-per-block body.

Each wrapper checks its inputs, allocates its outputs, launches on
PyTorch's current stream without synchronising, raises on a refused
launch, and counts the launch in ``<wrapper>.launches`` (a plain int; a
caller resets it to 0 before the run it wants to read). The plain
versions are in :mod:`apex_tpu_torch.ops.layer_norm`.
"""

import ctypes

import torch

from apex_tpu_torch.ops import _build

_NAME = "layer_norm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "layer_norm_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
                       _I),
    "layer_norm_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _P], _I),
    "layer_norm_error_string": ([_I], ctypes.c_char_p),
}
MAX_BWD_BLOCKS = 256   # dw/db partial rows of one backward launch


def supported(hidden):
    """Whether the kernels take rows of width ``hidden``: any width of at
    least one column."""
    return hidden >= 1


def vector_rows(hidden):
    """Whether rows of width ``hidden`` move in 16-byte vectors (and so
    must start on 16-byte boundaries); other widths load element by
    element."""
    return hidden % 8 == 0


def _check(name, x2d, vectors, row_tensors):
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
    align = 16 if vector_rows(hidden) else 1
    for tname, t in row_tensors:
        if (t.device != x2d.device or t.dtype != x2d.dtype
                or t.shape != x2d.shape or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{name}: {tname} must be a contiguous "
                             f"{x2d.dtype} {tuple(x2d.shape)} tensor on "
                             f"{x2d.device}, 16-byte aligned where hidden "
                             f"is a multiple of 8")
    for tname, t, shape in vectors:
        if t is None:
            continue
        if (t.device != x2d.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{name}: {tname} must be a contiguous fp32 "
                             f"{shape} tensor on {x2d.device}, 16-byte "
                             f"aligned where hidden is a multiple of 8")


def layer_norm_fwd(x2d, weight, bias, eps):
    """K3 on a ``[rows, hidden]`` CUDA tensor; ``weight``/``bias`` are
    fp32 ``[hidden]`` or None. Returns ``(y, mean, rstd)``: y in x's
    dtype, the statistics fp32 ``[rows]``."""
    rows, hidden = x2d.shape if x2d.dim() == 2 else (0, 0)
    _check("layer_norm_fwd", x2d,
           [("weight", weight, (hidden,)), ("bias", bias, (hidden,))],
           [("x", x2d)])
    y = torch.empty_like(x2d)
    mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    _build.launch(_NAME, _SIGNATURES, "layer_norm_fwd", x2d.device,
                  x2d.data_ptr(),
                  None if weight is None else weight.data_ptr(),
                  None if bias is None else bias.data_ptr(), y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
                  _build.DTYPE_CODES[x2d.dtype])
    layer_norm_fwd.launches += 1
    return y, mean, rstd


def layer_norm_bwd(x2d, weight, mean, rstd, dy):
    """K4: ``(dx, dw_part, db_part)`` with dx in x's dtype and the fp32
    affine-gradient partials ``[nblocks, hidden]`` (one row per block of
    rows; the caller sums them over blocks)."""
    rows, hidden = x2d.shape if x2d.dim() == 2 else (0, 0)
    _check("layer_norm_bwd", x2d,
           [("weight", weight, (hidden,)), ("mean", mean, (rows,)),
            ("rstd", rstd, (rows,))],
           [("x", x2d), ("dy", dy)])
    rows_per_block = -(-rows // MAX_BWD_BLOCKS)
    nblocks = -(-rows // rows_per_block)
    dx = torch.empty_like(x2d)
    dw_part = torch.empty(nblocks, hidden, dtype=torch.float32,
                          device=x2d.device)
    db_part = torch.empty_like(dw_part)
    _build.launch(_NAME, _SIGNATURES, "layer_norm_bwd", x2d.device,
                  x2d.data_ptr(),
                  None if weight is None else weight.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
                  rows, hidden, rows_per_block, nblocks,
                  _build.DTYPE_CODES[x2d.dtype])
    layer_norm_bwd.launches += 1
    return dx, dw_part, db_part


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0
