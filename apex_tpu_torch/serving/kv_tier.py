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

The host swap tier (``kv_swap=`` / ``APEX_SERVE_KV_SWAP``, default off;
it needs KV-pressure preemption, ``preempt=True``): at preemption the
victim's live pages, every leaf of the cache (the int8 tier's codes and
scales too), are copied device to host into a :class:`SwappedPages`
handle (pinned memory on the card) sealed by a sha1 over its bytes, and
re-admission checks the seal and copies the pages back into the slot's
freshly granted pages in place, so the stream resumes decode without a
replay prefill. A copy that fails (the ``serve_swap`` chaos site) or a
handle whose seal broke falls back to the replay, with a ``swap_failed``
event. Whether a resumed stream restores by swap-in or by
recompute is :func:`resolve_kv_restore`'s: a demand, else
``APEX_SERVE_KV_RESTORE``, else ``"swap"`` while the tier is on. (JAX
consults a measured dispatch table between the preference and the
default; its entries were taken on a JAX backend and all choose
``"swap"``, and the port has no table of its own.) JAX's handle holds the
page axis padded to ``max_pages`` (a program compiled once); the port's
holds the live pages only.
"""

import dataclasses
import hashlib
from typing import Any, Dict, Optional

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


def resolve_kv_swap(per_call=None):
    """The effective host-swap-tier decision: per-call demand >
    ``APEX_SERVE_KV_SWAP`` preference ("1"/"0") > off. The pairing with
    preemption is the engine's (it sees which side was a demand)."""
    if per_call is not None:
        return bool(per_call)
    v = _env.env_choice("APEX_SERVE_KV_SWAP", ("1", "0"))
    if v is not None:
        return v == "1"
    return False


def resolve_kv_restore(per_call=None, *, swap_enabled):
    """The restore path of one resumed stream: per-call demand (an
    unknown word raises, and so does ``"swap"`` with the tier off) >
    ``APEX_SERVE_KV_RESTORE`` preference > ``"swap"`` with the tier on,
    ``"recompute"`` (the replay prefill) with it off."""
    if per_call is not None:
        if per_call not in RESTORE_CHOICES:
            raise ValueError(
                f"unknown kv_restore {per_call!r} "
                f"(vocabulary: {RESTORE_CHOICES})")
        if per_call == "swap" and not swap_enabled:
            raise ValueError(
                "kv_restore='swap' demanded but the host swap tier is "
                "off (enable kv_swap=/APEX_SERVE_KV_SWAP=1) — no "
                "honorable way to restore from pages that were never "
                "banked")
        return per_call
    if not swap_enabled:
        return "recompute"
    return _env.env_choice("APEX_SERVE_KV_RESTORE", RESTORE_CHOICES) \
        or "swap"


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


# ---------------------------------------------------------------------------
# the host swap tier


def _host_bytes(t):
    """A host tensor's bytes, whatever its dtype (numpy has no bf16)."""
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


@dataclasses.dataclass
class SwappedPages:
    """Host copy of one preempted stream's live pages: ``leaves`` maps
    each cache leaf name to a host tensor ``[L, h, page_count, ...]``
    (the page axis at axis 2, as in the cache). The sha1 seals the bytes
    (the digest is JAX's: name, dtype name, shape and bytes of each leaf
    in name order, after the page count, token count and tier); a handle
    whose bytes no longer match is refused at swap-in."""

    leaves: Dict[str, Any]
    page_count: int           # live pages banked
    tokens: int               # known-stream length the pages cover
    quant: bool
    checksum: Optional[str] = None

    def nbytes(self):
        return int(sum(t.numel() * t.element_size()
                       for t in self.leaves.values()))

    def _digest(self):
        h = hashlib.sha1()
        h.update(repr((self.page_count, self.tokens,
                       self.quant)).encode())
        for name in sorted(self.leaves):
            t = self.leaves[name]
            h.update(name.encode())
            h.update(str(t.dtype).removeprefix("torch.").encode())
            h.update(repr(tuple(t.shape)).encode())
            h.update(_host_bytes(t))
        return h.hexdigest()

    def seal(self):
        self.checksum = self._digest()
        return self

    def intact(self):
        """Whether the banked bytes still match the seal."""
        return self.checksum is not None \
            and self.checksum == self._digest()


@dataclasses.dataclass
class KVTierStats:
    """Counters of the swap tier (``kv_tier_rates``'s ``swap_rate`` and
    ``swapped_pages_high_water``)."""

    swap_outs: int = 0
    swap_out_failures: int = 0
    swap_ins: int = 0
    swap_in_failures: int = 0
    restores_swap: int = 0
    restores_recompute: int = 0
    swapped_pages_live: int = 0
    swapped_pages_high_water: int = 0
    swapped_bytes_live: int = 0
    swapped_bytes_high_water: int = 0

    def banked(self, handle):
        self.swap_outs += 1
        self.swapped_pages_live += handle.page_count
        self.swapped_bytes_live += handle.nbytes()
        self.swapped_pages_high_water = max(
            self.swapped_pages_high_water, self.swapped_pages_live)
        self.swapped_bytes_high_water = max(
            self.swapped_bytes_high_water, self.swapped_bytes_live)

    def released(self, handle):
        self.swapped_pages_live -= handle.page_count
        self.swapped_bytes_live -= handle.nbytes()
