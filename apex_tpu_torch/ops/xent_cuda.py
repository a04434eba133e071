"""Wrappers of the hand-written CUDA fused LM head (``csrc/xent.cu``): K7
:func:`xent_fwd` replaces ``apex_tpu/ops/xent_pallas.py:417 _fwd`` (its
``pallas_call`` at ``:429``), K7p :func:`xent_fwd_partials` replaces the
vocabulary-shard forward ``:321 _fwd_sharded`` (its ``pallas_call`` at
``:339``), K8 :func:`xent_bwd_dx` and K9 :func:`xent_bwd_de` replace the
two calls of ``:449 _bwd_kernels`` (dX at ``:467``, dE at ``:482``), on a
whole table or, with ``v_total``, on a shard. The source's header says
what bounds them (the tensor-core rate) and how the design answers that.
For bf16 and fp16 at widths ``h % 64 == 0`` up to 1024, K8 and K9 run on
Hopper's ``wgmma`` with TMA loads (``xent_bwd_tc``, one body built for
``h = 768`` and one for the other widths), and so does the first stage of
K7 and K7p at any width ``h % 64 == 0`` (``xent_fwd_tc``, see
:func:`fwd_tc_takes`); fp32 takes the CUDA-core form
(``xent_dx_simt``/``xent_de_simt``, ``xent_fwd_partial_kernel<float>``)
and the other half-type widths the ``wmma`` form
(``xent_dx_wmma``/``xent_de_wmma``, ``xent_fwd_partial_kernel``). The
choice goes by dtype and shape alone.

Each wrapper checks its inputs, allocates its outputs, launches on
PyTorch's current stream without synchronising, raises on a refused
launch, and counts the launch in ``<wrapper>.launches`` (a plain int; a
caller resets it to 0 before the run it wants to read). They take x
``[n, h]`` and E ``[V, h]`` of one dtype (bf16, fp16 or fp32), int32
labels ``[n]``, any ``n >= 1``, ``V`` a multiple of 128 and ``h`` a
multiple of 32: every shape :func:`apex_tpu_torch.ops.xent.supported`
admits. The plain versions are in :mod:`apex_tpu_torch.ops.xent`.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.ops import _build

_NAME = "xent"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "xent_fwd": ([_P] * 6 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "xent_fwd_partials": ([_P] * 5 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "xent_bwd_dx": ([_P] * 6 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "xent_bwd_de": ([_P] * 6 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "xent_error_string": ([_I], ctypes.c_char_p),
}
VOCAB_TILE = 128   # V must be a multiple of it
DEPTH_TILE = 32    # h must be a multiple of it
FWD_ROWS = 128     # rows of one K7 block
FWD_TC_VOCAB = 256  # vocabulary columns of a tensor-core K7 tile


def _check(name, x, e, labels, rows=()):
    if x.dim() != 2 or not x.is_cuda:
        raise ValueError(f"{name}: x must be a 2-D CUDA tensor")
    n, h = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} (want bf16/fp16/fp32)")
    if e.dim() != 2 or e.shape[1] != h:
        raise ValueError(f"{name}: embedding must be [V, {h}], got "
                         f"{tuple(e.shape)}")
    V = e.shape[0]
    if n < 1 or V < VOCAB_TILE or V % VOCAB_TILE or h < DEPTH_TILE \
            or h % DEPTH_TILE:
        raise ValueError(f"{name}: shape [{n},{h}]x[{V},{h}] (the kernels "
                         f"take n >= 1, V a multiple of {VOCAB_TILE} and h "
                         f"a multiple of {DEPTH_TILE})")
    for tname, t in (("x", x), ("embedding", e)):
        if (t.device != x.device or t.dtype != x.dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {tname} must be a contiguous, "
                             f"16-byte aligned {x.dtype} tensor on "
                             f"{x.device}")
    for tname, t, dtype in (("labels", labels, torch.int32), *rows):
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != (n,) or not t.is_contiguous()):
            raise ValueError(f"{name}: {tname} must be a contiguous {dtype} "
                             f"[{n}] tensor on {x.device}")
    return n, V, h


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def fwd_tc_takes(dtype, h):
    """Whether K7 and K7p run on the tensor-core body (``xent_fwd_tc``):
    bf16 and fp16 at widths ``h % 64 == 0``, as ``csrc/xent.cu``'s
    ``fwd_tc_takes`` decides."""
    return dtype in (torch.bfloat16, torch.float16) and h % 64 == 0


def _vocab_splits(n, V, h, dtype, device):
    """K7's number of vocabulary shares. The tensor-core body runs one
    block an SM over 256-wide tiles: the count whose grid takes the fewest
    waves times tiles a block, the least such. The other forms run two
    blocks an SM over 128-wide tiles: enough blocks for two an SM, at most
    one share a tile."""
    row_tiles = -(-n // FWD_ROWS)
    sms = _sm_count(device.index)
    if fwd_tc_takes(dtype, h):
        tiles = -(-V // FWD_TC_VOCAB)
        return min(range(1, tiles + 1), key=lambda s: (
            -(-row_tiles * s // sms) * -(-tiles // s), s))
    return max(1, min(V // VOCAB_TILE, 2 * sms // row_tiles))


def xent_fwd(x, e, labels, smoothing=0.0):
    """K7: ``(loss, lse)``, each fp32 ``[n]``."""
    n, V, h = _check("xent_fwd", x, e, labels)
    nsplit = _vocab_splits(n, V, h, x.dtype, x.device)
    part = torch.empty(4, nsplit, n, dtype=torch.float32, device=x.device)
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    _build.launch(_NAME, _SIGNATURES, "xent_fwd", x.device, x.data_ptr(),
                  e.data_ptr(), labels.data_ptr(), part.data_ptr(),
                  loss.data_ptr(), lse.data_ptr(), n, V, h, nsplit,
                  float(smoothing), _build.DTYPE_CODES[x.dtype])
    xent_fwd.launches += 1
    return loss, lse


def xent_fwd_partials(x, e_shard, labels_local, smoothing=0.0):
    """K7p: fp32 ``[4, n]``, the rows' (max, sum of exponentials at that
    max, target logit, logits sum) over one vocabulary shard ``e_shard
    [Vs, h]``; ``labels_local`` are shard-local int32 ids (one outside
    ``[0, Vs)`` has no target on this shard); the logits sum is 0 without
    smoothing."""
    n, V, h = _check("xent_fwd_partials", x, e_shard, labels_local)
    nsplit = _vocab_splits(n, V, h, x.dtype, x.device)
    part = torch.empty(4, nsplit, n, dtype=torch.float32, device=x.device)
    out = torch.empty(4, n, dtype=torch.float32, device=x.device)
    _build.launch(_NAME, _SIGNATURES, "xent_fwd_partials", x.device,
                  x.data_ptr(), e_shard.data_ptr(), labels_local.data_ptr(),
                  part.data_ptr(), out.data_ptr(), n, V, h, nsplit,
                  float(smoothing), _build.DTYPE_CODES[x.dtype])
    xent_fwd_partials.launches += 1
    return out


def _bwd(fn_name, x, e, labels, lse, dl, smoothing, v_total, like):
    n, V, h = _check(fn_name, x, e, labels,
                     (("lse", lse, torch.float32), ("dl", dl, torch.float32)))
    v_total = V if v_total is None else int(v_total)
    if v_total < V:
        raise ValueError(f"{fn_name}: v_total {v_total} < the table's {V} "
                         f"rows")
    out = torch.empty_like(like)
    _build.launch(_NAME, _SIGNATURES, fn_name, x.device, x.data_ptr(),
                  e.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                  dl.data_ptr(), out.data_ptr(), n, V, h, v_total,
                  float(smoothing), _build.DTYPE_CODES[x.dtype])
    return out


def xent_bwd_dx(x, e, labels, lse, dl, smoothing=0.0, v_total=None):
    """K8: dX ``[n, h]`` in x's dtype, from K7's lse and the fp32
    cotangent ``dl [n]``; the uniform smoothing term divides by
    ``v_total`` (None: E's rows; a shard's caller passes the whole
    vocabulary)."""
    out = _bwd("xent_bwd_dx", x, e, labels, lse, dl, smoothing, v_total, x)
    xent_bwd_dx.launches += 1
    return out


def xent_bwd_de(x, e, labels, lse, dl, smoothing=0.0, v_total=None):
    """K9: dE ``[V, h]`` in E's dtype (``v_total`` as for K8). Each block
    owns its rows of dE, so two runs on the same inputs give the same
    bits."""
    out = _bwd("xent_bwd_de", x, e, labels, lse, dl, smoothing, v_total, e)
    xent_bwd_de.launches += 1
    return out


xent_fwd.launches = 0
xent_fwd_partials.launches = 0
xent_bwd_dx.launches = 0
xent_bwd_de.launches = 0
