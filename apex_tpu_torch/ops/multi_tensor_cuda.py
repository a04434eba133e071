"""Wrappers of the hand-written CUDA multi-tensor kernels
(``csrc/multi_tensor.cu``): K12 :func:`scale` and :func:`axpby`, K13
:func:`l2norm`, K14 :func:`adam`, K15 :func:`lamb`, K16 :func:`sgd`, and
the ZeRO shard updates K21 :func:`zero_adam` and K22
:func:`zero_lamb_stage1` / :func:`zero_lamb_stage2`. They replace no
Pallas site: the JAX package computes these in jnp
(``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``,
``apex_tpu/amp/scaler.py``, ``apex_tpu/optimizers/fused_adam.py``,
``fused_lamb.py``, ``fused_sgd.py``,
``apex_tpu/contrib/optimizers/distributed_fused_{adam,lamb}.py``); they
are the port's counterparts of apex's amp_C. The
source's header says what bounds them (bytes) and how the design answers
that.

Tensor lists. A launch takes a group of at most :func:`capacity` (depth)
tensors (depth: the operands each tensor brings, e.g. g, p, buf for
SGD): their device addresses and sizes travel in the kernel's
parameters, under the 4 KB limit, and a longer list takes one launch a
group. K14 and K15 take up to :func:`list_capacity` tensors a launch in
parameters of up to 32,764 bytes, so GPT-2-small's and BERT-large's
lists take one launch, on the grid :func:`plan` gives. Nothing
is staged in device memory and nothing waits on the host, so gradients
that are new tensors every step cost no more than fixed ones; a CUDA
graph that captures a call keeps the addresses it captured. A list of
mixed dtypes takes one group per dtype combination.

Each wrapper checks its inputs, allocates its outputs, launches on
PyTorch's current stream without synchronising, raises on a refused
launch, and counts each launch in ``<wrapper>.launches`` (a plain int; a
caller resets it to 0 before the run it wants to read). The plain
versions are in :mod:`apex_tpu_torch.ops.multi_tensor` (K12, K13) and in
the optimizers (K14: ``optimizers/fused_adam._adam_flat`` with the skip
selects of ``optimizers/_base.apply_plain``; K15: ``optimizers/
fused_lamb``'s two structures; K16: ``optimizers/fused_sgd``'s update with
``apply_plain`` and the model copy's cast; K21, K22: ``ops/zero``).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.multi_tensor import Norms

_NAME = "multi_tensor"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "multi_tensor_capacity": ([_I], _I),
    "multi_tensor_chunk": ([], _I),
    "multi_tensor_scale": ([_P, _P, _I, _I, _I, _P, _F, _P, _I, _I, _I, _P],
                           _I),
    "multi_tensor_axpby": ([_P, _P, _I, _I, _I, _F, _F, _P, _I, _I, _P], _I),
    "multi_tensor_norm_partials": ([_P, _P, _I, _I, _I, _P, _L, _I, _P], _I),
    "multi_tensor_norm_reduce": ([_P, _I, _I, _P, _L, _L, _P, _P, _I, _P, _P,
                                  _I, _P], _I),
    "multi_tensor_list_capacity": ([], _I),
    "multi_tensor_tile": ([], _I),
    "multi_tensor_list_resident": ([_I, _I, _I, _P, _I, _P], _I),
    "multi_tensor_adam": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
    "multi_tensor_lamb": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
    "multi_tensor_sgd": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
    "multi_tensor_zero_adam": ([_P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _P],
                               _I),
    "multi_tensor_zero_lamb": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                _I, _P, _P, _P, _P, _P, _I, _P], _I),
    "multi_tensor_error_string": ([_I], ctypes.c_char_p),
}
# elements a block (csrc/multi_tensor.cu CHUNK), the bytes of a launch's
# tensor table (TABLE_BYTES) and K14's and K15's tiles (TILE); the card
# tests hold these to the C source's
CHUNK = 65536
TABLE_BYTES = 3840
TILE = 32768
_MAX_NUMEL = 2 ** 31 - 1


def capacity(depth):
    """The most tensors one launch takes with ``depth`` operands each."""
    return (TABLE_BYTES - 16) // (8 * depth + 8)


def chunks(numel):
    """The blocks (chunks of ``CHUNK`` elements) a tensor takes."""
    return -(-numel // CHUNK)


def tiles(numel):
    """K14's items (and K15's stage-2 items) a tensor takes."""
    return -(-numel // TILE)


class Plan(NamedTuple):
    """A launch of K14 or K15 over one list: ``grid`` the blocks."""
    grid: int


def plan(kind, numels, sm_count, resident):
    """The launch of ``kind`` ("adam": K14, "lamb": K15) over tensors of
    ``numels`` elements on a card of ``sm_count`` SMs that holds
    ``resident`` blocks of the kernel an SM: a grid of every block the
    card holds, K14's at most one a tile (K15's launch is cooperative:
    every block resident). Pure: it reads sizes only, so a list gets the
    same plan every step, and the kernels' bits do not depend on it."""
    grid = max(1, sm_count * resident)
    if kind == "adam":
        grid = max(1, min(grid, sum(tiles(x) for x in numels)))
    return Plan(grid)


def _device(name, *lists):
    first = lists[0][0] if lists and lists[0] else None
    if first is None:
        raise ValueError(f"{name}: an empty tensor list")
    dev = first.device
    for lst in lists:
        if len(lst) != len(lists[0]):
            raise ValueError(f"{name}: lists of {[len(x) for x in lists]} "
                             f"tensors")
        for t in lst:
            if not t.is_cuda or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name}: want contiguous CUDA tensors on "
                                 f"{dev}, got {tuple(t.shape)} on "
                                 f"{t.device}")
            if t.dtype not in _build.DTYPE_CODES:
                raise ValueError(f"{name}: dtype {t.dtype} (want "
                                 f"bf16/fp16/fp32)")
            if t.numel() > _MAX_NUMEL:
                raise ValueError(f"{name}: a tensor of {t.numel()} elements "
                                 f"(at most {_MAX_NUMEL})")
    return dev


def _groups(idx, depth):
    cap = capacity(depth)
    return [idx[i:i + cap] for i in range(0, len(idx), cap)]


def _list_groups(idx, cap):
    """K14's and K15's launches: a list of one dtype pair in groups of at
    most ``cap`` tensors (:func:`list_capacity`; one group at GPT-2-small's
    148 and BERT-large's 302)."""
    return [idx[i:i + cap] for i in range(0, len(idx), cap)]


_list_cap = []


def list_capacity():
    """The tensors a K14 or K15 launch takes, as the built kernel has it
    (``multi_tensor_list_capacity``: 737 where the toolkit is CUDA 12.1
    or later, whose kernel parameters hold 32,764 bytes; 85 in the 4 KB
    of older ones)."""
    if not _list_cap:
        _list_cap.append(
            _build.load(_NAME, _SIGNATURES).multi_tensor_list_capacity())
    return _list_cap[0]


# (device index, kind, g dtype code, p dtype code) -> blocks an SM
_resident = {}
_sm_count = {}
_FORMS = {"adam": 0, "lamb": 1}
# (plan, kind, device index, dtypes, sizes) -> (Plan, chunks): a list's
# launch by its layout, asked of :func:`plan` once (the function is in the
# key, so a plan that tests patch in is asked too)
_layouts = {}


def resident(kind, g_dtype, p_dtype, dev):
    """The blocks of ``kind``'s kernel for these dtypes that one SM holds
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through the
    C entry), and the card's SMs."""
    key = (dev.index, kind, _code(g_dtype), _code(p_dtype))
    if key not in _resident:
        out = ctypes.c_int(0)
        _build.launch(_NAME, _SIGNATURES, "multi_tensor_list_resident", dev,
                      _FORMS[kind], key[2], key[3], ctypes.addressof(out))
        if out.value < 1:
            raise RuntimeError(f"multi_tensor {kind}: no block of its kernel "
                               f"fits an SM")
        _resident[key] = out.value
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _resident[key], _sm_count[dev.index]


def _layout(kind, numels, dg, dp, dev):
    """:func:`plan` for one group of sizes ``numels`` (an int64 array) on
    ``dev``, and the group's chunks; kept by the group's layout."""
    key = (plan, kind, dev.index, dg, dp, numels.tobytes())
    if key not in _layouts:
        if len(_layouts) >= 64:
            _layouts.clear()
        res, sms = resident(kind, dg, dp, dev)
        sizes = numels.tolist()
        _layouts[key] = (plan(kind, sizes, sms, res),
                         sum(chunks(x) for x in sizes))
    return _layouts[key]


def _by_dtype(key, n):
    """Indices 0..n-1 grouped by ``key(i)``, in first-seen order."""
    out = {}
    for i in range(n):
        out.setdefault(key(i), []).append(i)
    return out.items()


def _table(lists, idx):
    """The host arrays of one group: addresses [depth, n] and sizes [n]."""
    ptrs = np.array([[lst[i].data_ptr() for i in idx] for lst in lists],
                    dtype=np.int64)
    numels = np.array([lists[0][i].numel() for i in idx], dtype=np.int64)
    return ptrs, numels


def _scalar(name, value, dev):
    """``(device address, value)`` of a number or a 0-d fp32 tensor on
    ``dev`` (the kernel reads the tensor)."""
    if torch.is_tensor(value):
        if value.dim() != 0 or value.dtype != torch.float32 \
                or value.device != dev:
            raise ValueError(f"{name}: a scalar tensor must be 0-d fp32 on "
                             f"{dev}, got {value.dtype} {tuple(value.shape)} "
                             f"on {value.device}")
        return value.data_ptr(), 0.0
    return None, float(value)


def _code(dtype):
    return _build.DTYPE_CODES[dtype]


def scale(srcs, out_dtypes, factor, check_input=False,
          flag_dtype=torch.int32):
    """K12: ``outs[i] = srcs[i] * factor`` in fp32, cast to
    ``out_dtypes[i]``, and a 0-d ``flag_dtype`` (int32 or bool) flag set
    when an input (``check_input``: the loss scaler's check) or an fp32
    product (``multi_tensor_scale``'s) is not finite. ``factor`` is a
    number or a 0-d fp32 tensor on the tensors' device (read on the
    device). Returns ``(outs, flag)``."""
    dev = _device("multi_tensor scale", srcs)
    if len(out_dtypes) != len(srcs):
        raise ValueError("multi_tensor scale: one output dtype a tensor")
    flag = torch.zeros((), dtype=flag_dtype, device=dev)
    outs = [torch.empty_like(s, dtype=dt) for s, dt in zip(srcs, out_dtypes)]
    sptr, sval = _scalar("multi_tensor scale", factor, dev)
    live = [i for i, s in enumerate(srcs) if s.numel()]
    for (din, dout), idx in _by_dtype(
            lambda j: (srcs[live[j]].dtype, outs[live[j]].dtype), len(live)):
        for grp in _groups([live[j] for j in idx], 2):
            ptrs, numels = _table((srcs, outs), grp)
            _build.launch(_NAME, _SIGNATURES, "multi_tensor_scale", dev,
                          ptrs.ctypes.data, numels.ctypes.data, len(grp),
                          _code(din), _code(dout), sptr, sval,
                          flag.data_ptr(), flag.element_size(),
                          int(bool(check_input)))
            scale.launches += 1
    return outs, flag


def axpby(xs, ys, out_dtypes, a, b, flag_dtype=torch.int32):
    """K12's axpby form: ``outs[i] = a * xs[i] + b * ys[i]`` in fp32 (two
    products, one sum), cast to ``out_dtypes[i]``, and the flag set when a
    sum is not finite. A pair of different dtypes is upcast to fp32 first
    (exact). Returns ``(outs, flag)``."""
    dev = _device("multi_tensor axpby", xs, ys)
    if len(out_dtypes) != len(xs):
        raise ValueError("multi_tensor axpby: one output dtype a tensor")
    xs, ys = list(xs), list(ys)
    for i, (x, y) in enumerate(zip(xs, ys)):
        if x.shape != y.shape:
            raise ValueError(f"multi_tensor axpby: shapes {tuple(x.shape)} "
                             f"and {tuple(y.shape)}")
        if x.dtype != y.dtype:
            xs[i], ys[i] = x.float(), y.float()
    flag = torch.zeros((), dtype=flag_dtype, device=dev)
    outs = [torch.empty_like(x, dtype=dt) for x, dt in zip(xs, out_dtypes)]
    live = [i for i, x in enumerate(xs) if x.numel()]
    for (din, dout), idx in _by_dtype(
            lambda j: (xs[live[j]].dtype, outs[live[j]].dtype), len(live)):
        for grp in _groups([live[j] for j in idx], 3):
            ptrs, numels = _table((xs, ys, outs), grp)
            _build.launch(_NAME, _SIGNATURES, "multi_tensor_axpby", dev,
                          ptrs.ctypes.data, numels.ctypes.data, len(grp),
                          _code(din), _code(dout), float(a), float(b),
                          flag.data_ptr(), flag.element_size())
            axpby.launches += 1
    return outs, flag


def l2norm(tensors, max_mode=False):
    """K13: each tensor's sum of squares and L2 norm, and the list's (the
    tensors' sums added in list order), in two fixed-order stages with no
    atomics, so two runs give the same bits; with ``max_mode`` the largest
    magnitudes instead (NaN-propagating; ``total_sq``/``per_tensor_sq``
    then hold the same values). A list of mixed dtypes is upcast to fp32
    first. Returns :class:`Norms` of fp32 tensors: ``total`` and
    ``total_sq`` 0-d, ``per_tensor`` and ``per_tensor_sq`` ``[n]``."""
    dev = _device("multi_tensor l2norm", tensors)
    tensors = list(tensors)
    if len({t.dtype for t in tensors}) > 1:
        tensors = [t.float() for t in tensors]
    n = len(tensors)
    counts = [chunks(t.numel()) for t in tensors]
    partials = torch.empty(max(sum(counts), 1), dtype=torch.float32,
                           device=dev)
    per_sq = torch.empty(n, dtype=torch.float32, device=dev)
    per = torch.empty(n, dtype=torch.float32, device=dev)
    total_sq = torch.empty((), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    groups = _groups(list(range(n)), 1)
    code = _code(tensors[0].dtype)
    chunk_base = 0
    for g, grp in enumerate(groups):
        ptrs, numels = _table((tensors,), grp)
        if sum(counts[i] for i in grp):
            _build.launch(_NAME, _SIGNATURES, "multi_tensor_norm_partials",
                          dev, ptrs.ctypes.data, numels.ctypes.data,
                          len(grp), code, int(bool(max_mode)),
                          partials.data_ptr(), chunk_base)
            l2norm.launches += 1
        _build.launch(_NAME, _SIGNATURES, "multi_tensor_norm_reduce", dev,
                      numels.ctypes.data, len(grp), int(bool(max_mode)),
                      partials.data_ptr(), chunk_base, grp[0],
                      per_sq.data_ptr(), per.data_ptr(),
                      n if g == len(groups) - 1 else 0, total_sq.data_ptr(),
                      total.data_ptr())
        l2norm.launches += 1
        chunk_base += sum(counts[i] for i in grp)
    return Norms(total, per, total_sq, per_sq)


def _optimizer_lists(name, grads, params, ms, vs):
    """The four lists of K14/K15, checked; a gradient whose dtype is
    neither its parameter's nor fp32 is upcast to fp32 (exact)."""
    dev = _device(name, grads, params, ms, vs)
    grads = list(grads)
    for i, (g, p, m, v) in enumerate(zip(grads, params, ms, vs)):
        if not (g.shape == p.shape == m.shape == v.shape):
            raise ValueError(f"{name}: shapes {tuple(g.shape)}, "
                             f"{tuple(p.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"{name}: the moments must be fp32, got "
                             f"{m.dtype}, {v.dtype}")
        if g.dtype not in (p.dtype, torch.float32):
            grads[i] = g.float()
    return dev, grads


def _state_ptrs(name, dev, count, count_new, bc1, bc2, skip):
    for t, what, dt in ((count, "count", torch.int32),
                        (count_new, "count_new", torch.int32),
                        (bc1, "bc1", torch.float32),
                        (bc2, "bc2", torch.float32),
                        (skip, "skip", torch.bool)):
        if t is not None and (t.dim() != 0 or t.dtype != dt
                              or t.device != dev):
            raise ValueError(f"{name}: {what} must be a 0-d {dt} tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return [0 if t is None else t.data_ptr()
            for t in (count, count_new, bc1, bc2, skip)]


def adam(grads, params, ms, vs, count, count_new, bc1, bc2, lr, *, beta1,
         beta2, eps, weight_decay, adam_w_mode, bias_correction, skip=None):
    """K14: Adam (AdamW with ``adam_w_mode``) in place on every ``params[i]``
    (bf16/fp16/fp32) and its fp32 moments ``ms[i]``, ``vs[i]``, one launch
    a list (of one dtype pair, at most :func:`list_capacity` tensors), in the
    plain version's fp32 order (``optimizers/fused_adam._adam_flat``), the
    update cast to the gradient's dtype and then to the parameter's; and
    ``count = count_new``. ``bc1``, ``bc2`` (None without bias correction)
    and ``lr`` (a number, or a 0-d fp32 tensor) are read on the device.
    Where ``skip`` (a 0-d bool tensor, the found-inf flag) is set, nothing
    is written."""
    name = "multi_tensor adam"
    dev, grads = _optimizer_lists(name, grads, params, ms, vs)
    cptr, cnptr, b1ptr, b2ptr, sptr = _state_ptrs(name, dev, count,
                                                  count_new, bc1, bc2, skip)
    if bias_correction and (bc1 is None or bc2 is None):
        raise ValueError(f"{name}: bias correction needs bc1 and bc2")
    neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
    lptr, lval = _scalar(name, neg_lr, dev)
    hyper = np.array([beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                      weight_decay, 0.0, 0.0, lval], dtype=np.float32)
    flags = np.array([bool(adam_w_mode), bool(bias_correction),
                      weight_decay != 0, 0], dtype=np.int32)
    devptrs = np.array([b1ptr, b2ptr, lptr or 0, 0, sptr, cptr, cnptr],
                       dtype=np.int64)
    lists = (grads, params, ms, vs)
    for (dg, dp), idx in _by_dtype(
            lambda i: (grads[i].dtype, params[i].dtype), len(grads)):
        for grp in _list_groups(idx, list_capacity()):
            ptrs, numels = _table(lists, grp)
            pl, _ = _layout("adam", numels, dg, dp, dev)
            _build.launch(_NAME, _SIGNATURES, "multi_tensor_adam", dev,
                          ptrs.ctypes.data, numels.ctypes.data, len(grp),
                          _code(dg), _code(dp), pl.grid,
                          hyper.ctypes.data, flags.ctypes.data,
                          devptrs.ctypes.data)
            adam.launches += 1


def lamb(grads, params, ms, vs, count, count_new, bc1, bc2, lr, *, beta1,
         beta2, beta3, eps, weight_decay, adam_w_mode, bias_correction,
         max_grad_norm, trust, global_sq=None, skip=None):
    """K15: LAMB in place, one launch a list (of one dtype pair, at most
    :func:`list_capacity` tensors) in two stages a tensor. Stage 1 clips each
    gradient by ``max(sqrt(global_sq) / max_grad_norm, 1)`` (no clip when
    ``max_grad_norm`` is None or <= 0; ``global_sq`` the gradients' 0-d
    sum of squares from :func:`l2norm`), updates the fp32 moments in place
    (``beta3`` the gradient's coefficient in the first moment) and sums
    p^2 and the update direction's square by chunk; the tensor's sums, in
    a fixed order, give its trust ratio ``|p| / (|u| + 1e-38)`` (1 where
    either is 0, or everywhere unless ``trust``); stage 2 recomputes the
    direction from the new moments and writes ``p += (-lr * ratio) * u``,
    the update cast to the gradient's dtype and then to the parameter's;
    ``count = count_new``. The bits do not depend on :func:`plan`'s
    grid. Scalars as :func:`adam`; nothing is written where ``skip`` is
    set."""
    name = "multi_tensor lamb"
    dev, grads = _optimizer_lists(name, grads, params, ms, vs)
    cptr, cnptr, b1ptr, b2ptr, sptr = _state_ptrs(name, dev, count,
                                                  count_new, bc1, bc2, skip)
    if bias_correction and (bc1 is None or bc2 is None):
        raise ValueError(f"{name}: bias correction needs bc1 and bc2")
    clipping = max_grad_norm is not None and max_grad_norm > 0
    if clipping and global_sq is None:
        raise ValueError(f"{name}: clipping needs the global sum of squares")
    gptr = _scalar(name, global_sq, dev)[0] if clipping else 0
    neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
    lptr, lval = _scalar(name, neg_lr, dev)
    hyper = np.array([beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                      weight_decay, beta3,
                      max_grad_norm if clipping else 0.0, lval],
                     dtype=np.float32)
    flags = np.array([bool(adam_w_mode), bool(bias_correction),
                      weight_decay != 0, bool(trust)], dtype=np.int32)
    lists = (grads, params, ms, vs)
    for (dg, dp), idx in _by_dtype(
            lambda i: (grads[i].dtype, params[i].dtype), len(grads)):
        for grp in _list_groups(idx, list_capacity()):
            ptrs, numels = _table(lists, grp)
            pl, nch = _layout("lamb", numels, dg, dp, dev)
            # the chunks' sums of p^2 and u^2, then the tensors' steps
            scratch = torch.empty(2 * nch + len(grp), dtype=torch.float32,
                                  device=dev)
            devptrs = np.array([b1ptr, b2ptr, lptr or 0, gptr or 0, sptr,
                                cptr, cnptr, scratch.data_ptr(),
                                scratch[nch:].data_ptr(),
                                scratch[2 * nch:].data_ptr()],
                               dtype=np.int64)
            _build.launch(_NAME, _SIGNATURES, "multi_tensor_lamb", dev,
                          ptrs.ctypes.data, numels.ctypes.data, len(grp),
                          _code(dg), _code(dp), pl.grid,
                          hyper.ctypes.data, flags.ctypes.data,
                          devptrs.ctypes.data)
            lamb.launches += 1


def sgd(grads, params, bufs, model_params, count, count_new, lr, *,
        weight_decay, momentum, dampening, nesterov, skip=None):
    """K16: SGD with momentum in place on every ``params[i]`` (bf16/fp16/
    fp32) and its fp32 buffer ``bufs[i]``, in the plain version's fp32
    order (``optimizers/fused_sgd`` ``update``, then ``apply_plain``'s
    add): weight decay folded into g, ``buf = g`` where ``count_new`` is
    1 and ``momentum * buf + (1 - dampening) * g`` after, Nesterov's ``g +
    momentum * buf``, ``-lr * d`` cast to the gradient's dtype and then to
    the parameter's; ``count = count_new``. With ``model_params`` (a list,
    or None) each new parameter is also written into ``model_params[i]``
    in its dtype, the master-to-model copy of amp O2 in the same pass.
    ``lr`` is a number or a 0-d fp32 tensor read on the device; where
    ``skip`` (a 0-d bool tensor) is set, nothing is written."""
    name = "multi_tensor sgd"
    lists = [grads, params, bufs] + ([model_params] if model_params
                                     is not None else [])
    dev = _device(name, *lists)
    grads = list(grads)
    for i, (g, p, b) in enumerate(zip(grads, params, bufs)):
        shapes = [g.shape, p.shape, b.shape] + (
            [model_params[i].shape] if model_params is not None else [])
        if any(s != p.shape for s in shapes):
            raise ValueError(f"{name}: shapes {[tuple(s) for s in shapes]}")
        if b.dtype != torch.float32:
            raise ValueError(f"{name}: the momentum buffer must be fp32, "
                             f"got {b.dtype}")
        if g.dtype not in (p.dtype, torch.float32):
            grads[i] = g.float()
    for t, what, dt in ((count, "count", torch.int32),
                        (count_new, "count_new", torch.int32)):
        if t is None or t.dim() != 0 or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: {what} must be a 0-d {dt} tensor on "
                             f"{dev}")
    sptr = _state_ptrs(name, dev, None, None, None, None, skip)[4]
    neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
    lptr, lval = _scalar(name, neg_lr, dev)
    hyper = np.array([weight_decay, momentum, 1.0 - dampening, lval],
                     dtype=np.float32)
    flags = np.array([weight_decay != 0, momentum != 0, bool(nesterov)],
                     dtype=np.int32)
    devptrs = np.array([lptr or 0, sptr, count.data_ptr(),
                        count_new.data_ptr()], dtype=np.int64)
    mlist = model_params if model_params is not None else params

    def key(i):
        m = _code(model_params[i].dtype) if model_params is not None else -1
        return grads[i].dtype, params[i].dtype, m

    for (dg, dp, dm), idx in _by_dtype(key, len(grads)):
        for grp in _groups(idx, 4):
            ptrs, numels = _table((grads, params, bufs, mlist), grp)
            _build.launch(_NAME, _SIGNATURES, "multi_tensor_sgd", dev,
                          ptrs.ctypes.data, numels.ctypes.data, len(grp),
                          _code(dg), _code(dp), dm, hyper.ctypes.data,
                          flags.ctypes.data, devptrs.ctypes.data)
            sgd.launches += 1


def _shard(name, *tensors):
    dev = tensors[0].device
    n = tensors[0].numel()
    for t in tensors:
        if not t.is_cuda or t.device != dev or not t.is_contiguous() \
                or t.dtype != torch.float32 or t.dim() != 1 \
                or t.numel() != n:
            raise ValueError(f"{name}: want contiguous 1-d fp32 CUDA tensors "
                             f"of {n} elements on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if n == 0:
        raise ValueError(f"{name}: an empty shard")
    return dev


def zero_adam(g, master, m, v, count, count_new, bc1, bc2, lr, *, beta1,
              beta2, eps, weight_decay, adam_w_mode, bias_correction,
              skip=None):
    """K21: Adam on one rank's fp32 shard in ``_adam_flat``'s order (as
    K14): returns the update ``u = -lr * update`` (a new tensor, written
    on a skipped step too) and writes ``m``, ``v``, ``master += u`` and
    ``count = count_new`` in place unless the 0-d bool ``skip`` is set.
    Scalars as :func:`adam`."""
    name = "multi_tensor zero_adam"
    dev = _shard(name, g, master, m, v)
    cptr, cnptr, b1ptr, b2ptr, sptr = _state_ptrs(name, dev, count,
                                                  count_new, bc1, bc2, skip)
    if bias_correction and (bc1 is None or bc2 is None):
        raise ValueError(f"{name}: bias correction needs bc1 and bc2")
    neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
    lptr, lval = _scalar(name, neg_lr, dev)
    hyper = np.array([beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                      weight_decay, 0.0, 0.0, lval], dtype=np.float32)
    flags = np.array([bool(adam_w_mode), bool(bias_correction),
                      weight_decay != 0, 0], dtype=np.int32)
    devptrs = np.array([b1ptr, b2ptr, lptr or 0, 0, sptr, cptr, cnptr, 0, 0],
                       dtype=np.int64)
    u = torch.empty_like(g)
    _build.launch(_NAME, _SIGNATURES, "multi_tensor_zero_adam", dev,
                  g.data_ptr(), master.data_ptr(), m.data_ptr(), v.data_ptr(),
                  u.data_ptr(), g.numel(), hyper.ctypes.data,
                  flags.ctypes.data, devptrs.ctypes.data)
    zero_adam.launches += 1
    return u


def _pieces(name, layout, dev, n):
    arrays = layout.device_arrays(dev)
    if layout.shard != n:
        raise ValueError(f"{name}: a layout of {layout.shard} elements for "
                         f"a shard of {n}")
    return arrays


def zero_lamb_stage1(g, master, m, v, layout, count, count_new, bc1, bc2, *,
                     beta1, beta2, beta3, eps, weight_decay, adam_w_mode,
                     bias_correction, max_grad_norm, global_sq=None,
                     skip=None):
    """K22, stage 1 (two launches): on one rank's fp32 shard, the
    gradient clipped by ``max(sqrt(global_sq) / max_grad_norm, 1)`` (the
    all-reduced 0-d sum of squares), ``m`` and ``v`` in place and
    ``count = count_new`` unless ``skip`` is set, the direction ``u``
    (returned), and each segment's sums of ``p * p`` and ``u * u`` over
    the shard (``layout``: ``ops/zero.ShardLayout``), one block a piece
    and then a segment's pieces in order: returns ``(u, sums [2, N +
    1])``."""
    name = "multi_tensor zero_lamb"
    dev = _shard(name, g, master, m, v)
    start, lens, segs, first = _pieces(name, layout, dev, g.numel())
    cptr, cnptr, b1ptr, b2ptr, sptr = _state_ptrs(name, dev, count,
                                                  count_new, bc1, bc2, skip)
    if bias_correction and (bc1 is None or bc2 is None):
        raise ValueError(f"{name}: bias correction needs bc1 and bc2")
    clipping = max_grad_norm is not None and max_grad_norm > 0
    if clipping and global_sq is None:
        raise ValueError(f"{name}: clipping needs the global sum of squares")
    gptr = _scalar(name, global_sq, dev)[0] if clipping else 0
    hyper = np.array([beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                      weight_decay, beta3,
                      max_grad_norm if clipping else 0.0, 0.0],
                     dtype=np.float32)
    flags = np.array([bool(adam_w_mode), bool(bias_correction),
                      weight_decay != 0, 0], dtype=np.int32)
    devptrs = np.array([b1ptr, b2ptr, 0, gptr or 0, sptr, cptr, cnptr, 0, 0],
                       dtype=np.int64)
    u = torch.empty_like(g)
    partials = torch.empty(2 * layout.count, dtype=torch.float32, device=dev)
    sums = torch.empty((2, layout.nseg), dtype=torch.float32, device=dev)
    _build.launch(_NAME, _SIGNATURES, "multi_tensor_zero_lamb", dev, 1,
                  g.data_ptr(), master.data_ptr(), m.data_ptr(), v.data_ptr(),
                  u.data_ptr(), start.data_ptr(), lens.data_ptr(),
                  segs.data_ptr(), layout.count, first.data_ptr(),
                  layout.nseg, partials.data_ptr(), sums.data_ptr(),
                  hyper.ctypes.data, flags.ctypes.data, devptrs.ctypes.data)
    zero_lamb_stage1.launches += 2
    return u, sums


def zero_lamb_stage2(u, master, sums, layout, lr, *, trust, skip=None):
    """K22, stage 2: each segment's trust ratio ``|p| / (|u| + 1e-38)``
    from the all-reduced ``sums`` ``[2, N + 1]`` (1 where either is 0, for
    the padding segment, and everywhere unless ``trust``), then ``u =
    (-lr * ratio) * u`` in place and ``master += u`` unless ``skip`` is
    set. ``lr`` is a number or a 0-d fp32 tensor."""
    name = "multi_tensor zero_lamb"
    dev = _shard(name, u, master)
    start, lens, segs, first = _pieces(name, layout, dev, u.numel())
    if tuple(sums.shape) != (2, layout.nseg) or sums.device != dev \
            or sums.dtype != torch.float32 or not sums.is_contiguous():
        raise ValueError(f"{name}: sums must be contiguous fp32 [2, "
                         f"{layout.nseg}] on {dev}")
    sptr = _state_ptrs(name, dev, None, None, None, None, skip)[4]
    neg_lr = lr.neg() if torch.is_tensor(lr) else -lr
    lptr, lval = _scalar(name, neg_lr, dev)
    hyper = np.array([0.0] * 8 + [lval], dtype=np.float32)
    flags = np.array([0, 0, 0, bool(trust)], dtype=np.int32)
    devptrs = np.array([0, 0, lptr or 0, 0, sptr, 0, 0, 0, 0],
                       dtype=np.int64)
    _build.launch(_NAME, _SIGNATURES, "multi_tensor_zero_lamb", dev, 2,
                  None, master.data_ptr(), None, None, u.data_ptr(),
                  start.data_ptr(), lens.data_ptr(), segs.data_ptr(),
                  layout.count, first.data_ptr(), layout.nseg, None,
                  sums.data_ptr(), hyper.ctypes.data, flags.ctypes.data,
                  devptrs.ctypes.data)
    zero_lamb_stage2.launches += 1
    return u


scale.launches = 0
axpby.launches = 0
l2norm.launches = 0
adam.launches = 0
lamb.launches = 0
sgd.launches = 0
zero_adam.launches = 0
zero_lamb_stage1.launches = 0
zero_lamb_stage2.launches = 0
