"""The int8 KV tier's codec (counterpart of the codec half of
``apex_tpu/serving/kv_tier.py``).

With ``ServingEngine(kv_quant=True)`` the paged cache stores int8 codes
with per-(page, head) bf16 scales: half the bytes of a bf16 cache, so
about twice the pages at the same memory, which is the serving batch
ceiling. Prefill's page scatter quantizes at write
(:func:`prefill_scatter_quant`); the decode step re-quantizes each page
it writes, read-modify-write (:func:`decode_scatter_quant`); decode
attention dequantizes at read (K2q on the card,
``ops/decode_attention.py``). Null page 0 stays all-zero through the
codec: its scale is pinned to 0, and quantizing under a zero scale gives
int8 zeros (:func:`inv_scale`). Non-finite inputs become 0 before any
amax.

The functions are plain PyTorch on the cache's device, op for op with
the JAX codec (which is ``jnp`` inside the jitted programs, not a Pallas
kernel), and update the cache tensors in place. Rows are quantized under
the fp32 grown scale; the scale is stored in bf16, and dequantize reads
the stored one. ``torch.round`` and ``jnp.round`` both round half to
even. Where JAX scatters with ``.at[].max``, the port uses
``scatter_reduce_(..., "amax")``. The ``.set`` scatters carry duplicate
indices only at page 0 (padded prefill rows, inactive decode lanes), and
all of those write exact zeros, so the order of duplicate writes cannot
matter. A division by a constant divides by a tensor on the operand's
device: on the card PyTorch turns ``x / python_float`` into ``x *
(1 / python_float)``, which can round differently from JAX's division.

The host swap tier of the JAX module (``SwappedPages``, ``KVTierStats``,
``resolve_kv_swap``/``resolve_kv_restore``) needs KV-pressure preemption,
which the port's engine does not have yet; the engine refuses
``kv_swap=True`` and ``kv_restore="swap"``.
"""

import torch

from apex_tpu_torch import _env

# wire format of the quantized tier: int8 codes + per-(page, head) bf16
# scales (an amax/127, consumed in fp32)
CODE_DTYPE = torch.int8
SCALE_DTYPE = torch.bfloat16
QMAX = 127.0

SCALE_KEYS = ("k_scale", "v_scale")
RESTORE_CHOICES = ("recompute", "swap")


def resolve_kv_quant(per_call=None):
    """The effective int8-KV decision: per-call (the engine's
    ``kv_quant=``) > ``APEX_SERVE_KV_QUANT`` env preference ("1"/"0";
    other values warn once and are ignored) > off."""
    if per_call is not None:
        return bool(per_call)
    v = _env.env_choice("APEX_SERVE_KV_QUANT", ("1", "0"))
    if v is not None:
        return v == "1"
    return False


def is_quantized(cache):
    """Whether a cache dict carries the int8 tier's scale leaves."""
    return "k_scale" in cache


def finite(x):
    """NaN/Inf become 0 before any amax, so one poisoned activation can
    neither NaN a page scale nor saturate it to Inf."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _div(x, c):
    """``x / c`` as a true division on x's device (see the module
    docstring)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def inv_scale(scale):
    """Guarded fp32 reciprocal of a scale tensor: 0 where the scale is 0
    (the null page, an all-zero page), so quantizing under a dead scale
    gives exact int8 zeros instead of NaN codes."""
    s = scale.float()
    live = s > 0
    return torch.where(live, 1.0 / torch.where(live, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def quantize(x, scale):
    """int8 codes of ``x`` under per-leading-dims ``scale`` (broadcast over
    the trailing ``(page_size, head_dim)`` dims)."""
    inv = inv_scale(scale)[..., None, None]
    q = torch.round(finite(x).float() * inv)
    return torch.clamp(q, -QMAX, QMAX).to(CODE_DTYPE)


def dequantize(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize` (per-leading-dims scale broadcast over
    the trailing two dims)."""
    return (q.float() * scale.float()[..., None, None]).to(dtype)


def init_scales(num_layers, num_heads, num_pages, device=None):
    """Zeroed per-(page, head) scale leaves ``{"k_scale", "v_scale"}`` of
    ``[layers, h, num_pages]``: the page axis at axis 2 and the head axis
    at axis 1, as in the code tensors."""
    shape = (num_layers, num_heads, num_pages)
    return {k: torch.zeros(shape, dtype=SCALE_DTYPE, device=device)
            for k in SCALE_KEYS}


def prefill_scatter_quant(cache, layer, part, val, dest_page, dest_off,
                          keep_scale):
    """Quantize-at-write page scatter of the packed prefill (JAX
    ``:189``), in place on ``cache``.

    ``val`` is the layer's fresh K or V rows ``[s, h, d]``;
    ``dest_page``/``dest_off`` the packed rows' page and offset ``[s]``
    (int64); ``keep_scale`` ``[num_pages]`` fp32 is 1 for pages whose
    content and scale stay live and 0 for pages granted to this prefill,
    whose stale codes and scale are dead. Scatter-max the fresh rows'
    amax into a per-(head, page) scale floor, grow each page's surviving
    scale to cover it, re-quantize the layer under the grown scales
    (ratio 1 leaves a page's codes as they are; ratio 0 zeroes fresh
    pages and the null page), then quantize the fresh rows under the
    fp32 grown scale and scatter them. Page 0's scale is pinned to 0, so
    padded rows (routed to page 0) quantize to exact zeros."""
    q = cache[part]                      # [L, h, P, ps, d] int8
    sc = cache[part + "_scale"]          # [L, h, P] bf16
    h, num_pages = q.shape[1], q.shape[2]
    s = val.shape[0]
    vf = finite(val.float())                                   # [s, h, d]
    row_amax = vf.abs().amax(dim=-1)                           # [s, h]
    amax_pages = torch.zeros(h, num_pages, dtype=torch.float32,
                             device=q.device)
    amax_pages.scatter_reduce_(1, dest_page[None, :].expand(h, s),
                               row_amax.t(), "amax")
    old = sc[layer].float() * keep_scale[None, :]
    new_scale = torch.maximum(old, _div(amax_pages, QMAX))
    new_scale[:, 0] = 0.0                                      # null page pin
    live = new_scale > 0
    ratio = torch.where(
        live, old / torch.where(live, new_scale, torch.ones_like(new_scale)),
        torch.zeros_like(new_scale))
    requant = torch.clamp(torch.round(q[layer].float()
                                      * ratio[:, :, None, None]),
                          -QMAX, QMAX)
    dest_scale = new_scale[:, dest_page]                       # [h, s]
    rows = torch.round(vf * inv_scale(dest_scale).t()[:, :, None])
    rows = torch.clamp(rows, -QMAX, QMAX)                      # [s, h, d]
    # torch keeps the adjacent index pair at its position: [h, s, d]
    requant[:, dest_page, dest_off, :] = rows.transpose(0, 1)
    q[layer] = requant.to(CODE_DTYPE)
    sc[layer] = new_scale.to(SCALE_DTYPE)
    return cache


def decode_scatter_quant(cache, layer, part, val, write_page, write_off):
    """Quantize-at-write of the decode step's one row per lane (JAX
    ``:237``), in place on ``cache``: gather the B written pages,
    dequantize, zero the rows at and past the write offset (a fresh page
    arrives with ``write_off == 0``, so its stale codes die here), insert
    the new row, re-derive the page scale from the page's live content,
    re-quantize under that fp32 scale, scatter back. ``val`` is ``[B, h,
    d]``; ``write_page``/``write_off`` ``[B]`` (int64), inactive lanes
    routed to page 0, whose scale is forced to 0, so page 0 is re-written
    with exact zeros."""
    q = cache[part]                      # [L, h, P, ps, d] int8
    sc = cache[part + "_scale"]          # [L, h, P] bf16
    ps = q.shape[3]
    B = val.shape[0]
    pages_q = q[layer][:, write_page]                          # [h, B, ps, d]
    pscale = sc[layer][:, write_page]                          # [h, B]
    pf = dequantize(pages_q, pscale)                           # [h, B, ps, d]
    row_ids = torch.arange(ps, device=q.device)[None, None, :, None]
    pf = torch.where(row_ids < write_off[None, :, None, None], pf,
                     torch.zeros_like(pf))
    vf = finite(val.float()).transpose(0, 1)                   # [h, B, d]
    pf[:, torch.arange(B, device=q.device), write_off, :] = vf
    amax = pf.abs().amax(dim=(-2, -1))                         # [h, B]
    new_scale = torch.where(write_page[None, :] == 0, torch.zeros_like(amax),
                            _div(amax, QMAX))
    pq = torch.clamp(torch.round(pf * inv_scale(new_scale)[..., None, None]),
                     -QMAX, QMAX).to(CODE_DTYPE)
    q[layer][:, write_page] = pq
    sc[layer][:, write_page] = new_scale.to(SCALE_DTYPE)
    return cache
