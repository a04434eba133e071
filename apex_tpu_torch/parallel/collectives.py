"""Quantized and hierarchical collectives over ``torch.distributed``: the
one collectives layer (counterpart of ``apex_tpu/parallel/collectives.py``).

Every scale-out path of the port (DDP's ``allreduce_gradients`` and the
ZeRO-2 flat-buffer reduce-scatter and all-gather of
``contrib.optimizers.distributed_fused_{adam,lamb}``) moves its gradient
payload through this module, so the two levers land in one place:

* **int8 block quantization with error feedback**: a payload rides as
  int8 values and one bf16 scale a ``block`` (128) elements, and each
  rank's quantization error is an fp32 **residual** that the caller
  threads across steps. Each contribution is quantized once and the
  receiver sums in fp32. The codec is K19 (quantize) and K20
  (dequantize-and-sum) on the card, ``ops/collectives``.
* **hierarchical two-stage reduction** over a dp "axis" declared as an
  ``(inner, outer)`` pair: a reduce-scatter inside the inner groups, an
  all-reduce of the 1/inner shard over the outer groups (the only hop
  quantized when both knobs are on), an all-gather inside the inner
  groups.

Axes are process groups. An axis is one ``torch.distributed`` group (None:
the default group); a hierarchical axis is an ``(inner, outer)`` pair of
groups, which :func:`hierarchical_groups` builds for ``world = inner x
outer`` in JAX's mesh order, ``Mesh(devices.reshape(inner, outer),
("dp_in", "dp_out"))``: rank ``r = i * outer + o``, the inner group the
ranks with the same ``o``, the outer group those with the same ``i``. So
:func:`axes_index` of a pair is the rank itself, and a flat collective
over the pair (without the hierarchical route) runs over the pair's
``whole`` group (the default group). ``lax`` collectives map to
``torch.distributed`` as ``all_gather(tiled=False)`` to
``all_gather_into_tensor`` into a ``[W, ...]`` buffer (made flat, as
gloo takes it), ``psum_scatter(tiled=True)`` to ``reduce_scatter_tensor``,
``all_to_all`` to ``all_to_all_single``, ``psum`` to ``all_reduce``. A
group of one rank (or no initialized process group) makes each
collective the identity.

Knobs, as JAX's: per-call ``compress=`` / ``hierarchical=`` raise on a
request that cannot be honoured (an unknown scheme, hierarchical over a
group that is not a pair); the setters, ``APEX_GRAD_COMPRESS`` and
``APEX_HIER_ALLREDUCE`` are preferences that warn once and fall back. JAX
consults a dispatch table for op ``grad_comm`` below those tiers
(``_table_choice``); the port has no dispatch table, and JAX's own
``apex_tpu/dispatch/table.jsonl`` holds no ``grad_comm`` row, so that
tier is a miss in JAX too and the port leaves it out: every knob resolves
as JAX resolves it by default (``nelems`` is accepted for JAX's
signatures and changes nothing).
With both knobs off every entry point makes the plain collectives (one
all-reduce a leaf in :func:`allreduce_tree`).
"""

import contextlib
import os
import warnings

import torch
import torch.distributed as dist

from apex_tpu_torch import device_scalar
from apex_tpu_torch.ops import collectives as codec

SCHEMES = ("int8",)
DEFAULT_BLOCK = 128  # elements per scale: 2/128 bf16-scale overhead

# ---------------------------------------------------------------- knobs

_COMPRESS = None   # setter pin: None (consult env) | "off" | scheme
_HIER = None       # setter pin: None (consult env) | True | False
_FORCE_OFF = 0     # disabled() depth
_warned = set()


def _warn_once(msg):
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg)


def _env_compress():
    v = os.environ.get("APEX_GRAD_COMPRESS")
    if v in (None, "", "0", "off", "none"):
        return None
    if v in SCHEMES:
        return v
    _warn_once(f"APEX_GRAD_COMPRESS={v!r} is not a known scheme "
               f"{SCHEMES} — ignored (compression stays off)")
    return None


def _env_hier():
    v = os.environ.get("APEX_HIER_ALLREDUCE")
    if v == "1":
        return True
    if v in ("0", ""):
        return False
    if v is not None:
        _warn_once(f"APEX_HIER_ALLREDUCE={v!r} is not '1'/'0' — "
                   f"ignored (hierarchical stays off)")
    return None


def set_grad_compress(scheme):
    """Pin the process-wide compression preference: a scheme turns it on,
    ``"off"`` pins it off, None un-pins. An unknown scheme raises."""
    global _COMPRESS
    if scheme is not None and scheme != "off" and scheme not in SCHEMES:
        raise ValueError(f"unknown compression scheme {scheme!r} "
                         f"(known: {SCHEMES} or 'off'/None)")
    _COMPRESS = scheme


def set_hier_allreduce(value):
    """Pin the process-wide hierarchical preference (True/False), or
    un-pin with None; it engages only over an (inner, outer) pair."""
    global _HIER
    if value is not None and not isinstance(value, bool):
        raise ValueError(f"hier preference must be True/False/None, "
                         f"got {value!r}")
    _HIER = value


def resolve_compress(per_call=None, *, nelems=None):
    """The resolved scheme (None: off): per-call (raises on an unknown
    one) > setter > env. ``disabled()`` turns the preferences off, never
    an explicit per-call demand."""
    del nelems
    if per_call is not None:
        if per_call is False or per_call in ("off", "none"):
            return None
        if per_call not in SCHEMES:
            raise ValueError(f"unknown compression scheme {per_call!r} "
                             f"(known: {SCHEMES})")
        return per_call
    if _FORCE_OFF:
        return None
    if _COMPRESS is not None:
        return None if _COMPRESS == "off" else _COMPRESS
    return _env_compress()


def resolve_hier(per_call, axes, *, nelems=None):
    """Whether the two-stage route runs over ``axes``: a per-call True
    over a group that is not an (inner, outer) pair raises; the
    preference falls back to the flat collective there."""
    del nelems
    axes = axes_tuple(axes)
    if per_call is not None:
        if per_call and len(axes) != 2:
            raise ValueError(
                "hierarchical allreduce needs the axis declared as an "
                f"(inner, outer) pair of groups, got {len(axes)} group(s)")
        return bool(per_call)
    if _FORCE_OFF:
        return False
    pref = _HIER if _HIER is not None else _env_hier()
    return bool(pref) and len(axes) == 2


@contextlib.contextmanager
def disabled():
    """Inside the context every preference resolves off (explicit
    per-call demands still honour themselves)."""
    global _FORCE_OFF
    _FORCE_OFF += 1
    try:
        yield
    finally:
        _FORCE_OFF -= 1


def snapshot(nelems=None, axes=None):
    """The resolved configuration ``{"scheme", "hierarchical", "block"}``;
    with ``axes``, whether the two-stage route engages over them, else
    the raw preference."""
    if axes is not None:
        hier = resolve_hier(None, axes, nelems=nelems)
    elif _FORCE_OFF:
        hier = False
    else:
        hier = _HIER if _HIER is not None else _env_hier()
    return {"scheme": resolve_compress(None, nelems=nelems),
            "hierarchical": bool(hier),
            "block": DEFAULT_BLOCK}


def _reset_for_tests():
    global _COMPRESS, _HIER, _FORCE_OFF
    _COMPRESS = None
    _HIER = None
    _FORCE_OFF = 0
    _warned.clear()


# ----------------------------------------------------------- axis utils

class AxisPair(tuple):
    """A declared ``(inner, outer)`` pair of process groups; ``whole`` is
    the group of all their ranks (a flat collective over the pair)."""

    def __new__(cls, inner, outer, whole=None):
        pair = super().__new__(cls, (inner, outer))
        pair.whole = whole
        return pair


def hierarchical_groups(inner, outer):
    """The ``(inner, outer)`` pair of groups for ``world = inner x
    outer`` ranks in JAX's mesh order (rank ``i * outer + o``): this
    rank's inner group (the ranks with its ``o``) and outer group (those
    with its ``i``). Every rank must call it (``new_group`` is
    collective)."""
    world = dist.get_world_size()
    if inner * outer != world:
        raise ValueError(f"hierarchical_groups({inner}, {outer}): the world "
                         f"has {world} ranks")
    rank = dist.get_rank()
    i, o = divmod(rank, outer)
    mine = {}
    for oo in range(outer):
        g = dist.new_group([ii * outer + oo for ii in range(inner)])
        if oo == o:
            mine["inner"] = g
    for ii in range(inner):
        g = dist.new_group([ii * outer + oo for oo in range(outer)])
        if ii == i:
            mine["outer"] = g
    return AxisPair(mine["inner"], mine["outer"], dist.group.WORLD)


def axes_tuple(axis_name):
    """An axis (a group, or an (inner, outer) pair) as a tuple of groups."""
    if isinstance(axis_name, (tuple, list)):
        return tuple(axis_name) if not isinstance(axis_name, AxisPair) \
            else axis_name
    return (axis_name,)


def group_size(group):
    """The ranks of ``group`` (None: the default group); 1 without an
    initialized process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _group_rank(group):
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def axes_size(axis_name):
    """The product of the groups' sizes."""
    size = 1
    for g in axes_tuple(axis_name):
        size *= group_size(g)
    return size


def axes_index(axis_name):
    """Row-major rank over the axis tuple: the chunk a flat tuple-axis
    reduce-scatter gives this rank, and the one the staged inner-then-outer
    route gives it."""
    axes = axes_tuple(axis_name)
    idx = _group_rank(axes[0])
    for g in axes[1:]:
        idx = idx * group_size(g) + _group_rank(g)
    return idx


def _flat_group(axes):
    """The one group of a flat collective over ``axes``."""
    if len(axes) == 1:
        return axes[0]
    return getattr(axes, "whole", None)


# ------------------------------------------------- torch.distributed ops

def _gather_stack(x, group):
    """``lax.all_gather(x, tiled=False)``: ``[W, *x.shape]`` in rank
    order."""
    world = group_size(group)
    if world == 1:
        return x.unsqueeze(0)
    out = torch.empty((world * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    return out.view(world, *x.shape)


def _gather_tiled(x, group):
    """``lax.all_gather(x, tiled=True)`` of a flat ``[m]``: ``[W m]``."""
    return _gather_stack(x, group).reshape(-1)


def _psum_scatter(x, group):
    """``lax.psum_scatter(x, scatter_dimension=0, tiled=True)`` of a flat
    ``[P]``: this rank's ``[P / W]`` chunk of the sum."""
    world = group_size(group)
    if world == 1:
        return x
    assert x.shape[0] % world == 0, (x.shape, world)
    out = torch.empty((x.shape[0] // world,), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _psum(x, group):
    """``lax.psum``: a new tensor."""
    if group_size(group) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_to_all(x, group):
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)``."""
    if group_size(group) == 1:
        return x
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _div(x, world):
    """``x / world`` as a true division."""
    return x / device_scalar(world, x, x.dtype)


# --------------------------------------------------- flat-vector cores
# Everything below operates on ONE flat fp32 vector. All return (value,
# new_residual) where new_residual is None unless a residual was threaded
# in.

def quantized_allreduce_flat(x, axis_name, *, mean=False,
                             block=DEFAULT_BLOCK, residual=None):
    """Gather-based quantized all-reduce of a flat ``[n]``: each rank
    quantizes its compensated contribution once (K19), the int8 payload
    and scales are all-gathered, and each rank sums the W dequantized
    contributions in fp32 in rank order (K20)."""
    axes = axes_tuple(axis_name)
    group = _flat_group(axes)
    n = x.shape[-1]
    q, scales, new_res = codec.quantize(x, residual, block=block)
    gq = _gather_stack(q, group)          # [W, nb, block]
    gs = _gather_stack(scales, group)     # [W, nb]
    y = codec.dequantize_sum(gq, gs, n,
                             divisor=axes_size(axes) if mean else None)
    return y, new_res


def quantized_reduce_scatter_flat(x, axis_name, *, block=DEFAULT_BLOCK,
                                  residual=None):
    """Quantized reduce-scatter (sum) of a flat ``[P]`` over one group, P
    divisible by its size: the compensated vector quantized per
    destination shard (rows ``[W, P / W]``, each padded on its own), the
    payload exchanged by all-to-all, and this rank's W copies of its shard
    dequantized and summed in fp32 → ``[P / W]``."""
    (group,) = axes_tuple(axis_name)
    world = group_size(group)
    P = x.shape[-1]
    assert P % world == 0, (P, world)
    shard = P // world
    rows = x.view(world, shard)
    res = None if residual is None else residual.view(world, shard)
    q, scales, new_res = codec.quantize(rows, res, block=block)
    qs = _all_to_all(q, group)
    ss = _all_to_all(scales, group)
    y = codec.dequantize_sum(qs, ss, shard)
    return y, None if new_res is None else new_res.view(-1)


def quantized_all_gather_flat(shard, axis_name, *, block=DEFAULT_BLOCK,
                              residual=None):
    """Quantized all-gather of a flat ``[m]`` shard over one group →
    ``[W m]``: every rank dequantizes the same payload, so the result is
    the same bits on every rank."""
    (group,) = axes_tuple(axis_name)
    m = shard.shape[-1]
    q, scales, new_res = codec.quantize(shard, residual, block=block)
    gq = _gather_stack(q, group)
    gs = _gather_stack(scales, group)
    return codec.dequantize_sum(gq, gs, m, gather=True), new_res


def hierarchical_allreduce_flat(x, axis_name, *, mean=False, compress=None,
                                block=DEFAULT_BLOCK, residual=None):
    """Two-stage all-reduce of a flat ``[n]`` over an (inner, outer) pair:
    reduce-scatter inside the inner group, all-reduce of the 1/inner shard
    over the outer group (quantized with ``compress``: the only quantized
    hop), all-gather inside the inner group."""
    inner, outer = axes_tuple(axis_name)
    isz = group_size(inner)
    n = x.shape[-1]
    P = -(-n // isz) * isz
    xp = x.float()
    if P != n:
        xp = torch.nn.functional.pad(xp, (0, P - n))
    shard = _psum_scatter(xp, inner)
    if compress:
        shard, new_res = quantized_allreduce_flat(
            shard, (outer,), mean=False, block=block, residual=residual)
    else:
        shard = _psum(shard, outer)
        new_res = residual
    y = _gather_tiled(shard, inner)[:n]
    if mean:
        y = _div(y, isz * group_size(outer))
    return y, new_res


# ------------------------------------------------------ tree entry point

def _flat_size(leaves):
    return sum(t.numel() for t in leaves)


def _check_float(leaves, scheme):
    for leaf in leaves:
        if not leaf.is_floating_point():
            raise TypeError(
                f"compression scheme {scheme!r} needs floating-point "
                f"leaves, got {leaf.dtype}")


def ef_init(tree, axis_name, *, compress=None, hierarchical=None,
            block=DEFAULT_BLOCK):
    """The zero error-feedback residual :func:`allreduce_tree` carries for
    ``tree`` (a dict of tensors) under the resolved knobs: None when
    nothing is quantized; the 1/inner piece on the hierarchical route."""
    del block
    axes = axes_tuple(axis_name)
    leaves = list(tree.values())
    total = _flat_size(leaves)
    scheme = resolve_compress(compress)
    hier = resolve_hier(hierarchical, axes)
    if scheme is None:
        return None
    if hier:
        isz = group_size(axes[0])
        total = -(-total // isz)
    return torch.zeros((total,), dtype=torch.float32,
                       device=leaves[0].device)


def allreduce_tree(tree, axis_name, *, mean=True, compress=None,
                   hierarchical=None, ef_state=None, block=DEFAULT_BLOCK):
    """All-reduce a dict of tensors over ``axis_name`` (a group, or an
    (inner, outer) pair) under the resolved knobs; returns ``(tree,
    new_ef_state)``. Off: one all-reduce a leaf (then ``/ world``), the
    state passed through. Otherwise the leaves go through one flat fp32
    buffer, in JAX's leaf order for the tree the dotted names stand for
    (their parts sorted level by level), so that the quantization blocks
    and the residual are JAX's, and come back in their dtypes."""
    axes = axes_tuple(axis_name)
    names = sorted(tree, key=lambda n: n.split("."))
    leaves = [tree[k] for k in names]
    total = _flat_size(leaves)
    scheme = resolve_compress(compress)
    hier = resolve_hier(hierarchical, axes)
    if scheme is None and not hier:
        group = _flat_group(axes)
        world = axes_size(axes)
        out = {}
        for k, g in zip(names, leaves):
            g = _psum(g, group)
            out[k] = _div(g, world) if mean else g
        return {k: out[k] for k in tree}, ef_state
    if scheme is not None:
        _check_float(leaves, scheme)
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    if hier:
        red, new_res = hierarchical_allreduce_flat(
            flat, axes, mean=mean, compress=scheme, block=block,
            residual=ef_state)
    else:
        red, new_res = quantized_allreduce_flat(
            flat, axes, mean=mean, block=block, residual=ef_state)
    out, off = {}, 0
    for k, t in zip(names, leaves):
        out[k] = red[off:off + t.numel()].view(t.shape).to(t.dtype)
        off += t.numel()
    return {k: out[k] for k in tree}, new_res


# --------------------------------------- ZeRO flat-buffer entry points
# consumed by optimizers._fused.zero_grad_shard / zero_gather_updates: the
# staged (inner, outer) routes give the same chunk ownership as the flat
# collectives over the pair (axes_index row-major).

def reduce_scatter_flat(x, axis_name, *, compress=None, hierarchical=None,
                        block=DEFAULT_BLOCK, residual=None):
    """Reduce-scatter (sum) a flat ``[P]`` over ``axis_name``, P divisible
    by the total size: returns ``([P / W] shard, new_residual)``.
    Hierarchical: a reduce-scatter inside the inner group, then one of the
    1/inner piece over the outer group (the only hop quantized)."""
    axes = axes_tuple(axis_name)
    scheme = resolve_compress(compress)
    hier = resolve_hier(hierarchical, axes)
    kw = dict(block=block, residual=residual)
    if hier:
        inner, outer = axes
        piece = _psum_scatter(x, inner)
        if scheme is not None:
            return quantized_reduce_scatter_flat(piece, (outer,), **kw)
        return _psum_scatter(piece, outer), residual
    if scheme is not None:
        if len(axes) > 1:
            return _quantized_rs_multi(x, axes, **kw)
        return quantized_reduce_scatter_flat(x, axes, **kw)
    return _psum_scatter(x, _flat_group(axes)), residual


def _quantized_rs_multi(x, axes, **kw):
    """Quantized reduce-scatter over a tuple of groups without the
    declared route: quantized over the first group (the full-width hop:
    a flat tuple reduce-scatter is row-major, so the first group is the
    outermost chunk index), then full precision over the rest."""
    first, rest = axes[0], axes[1:]
    y, new_res = quantized_reduce_scatter_flat(x, (first,), **kw)
    for g in rest:
        y = _psum_scatter(y, g)
    return y, new_res


def all_gather_flat(shard, axis_name, *, compress=None, hierarchical=None,
                    block=DEFAULT_BLOCK, residual=None,
                    gather_dtype=torch.float32):
    """All-gather a flat ``[P / W]`` shard over ``axis_name`` → ``[P]``;
    returns ``(full, new_residual)``. Hierarchical: the outer group's
    gather first (outer is the innermost chunk index: the inverse of
    :func:`reduce_scatter_flat`), quantized under ``compress``, then the
    inner group's at full width. ``gather_dtype`` applies to the
    uncompressed hops."""
    axes = axes_tuple(axis_name)
    scheme = resolve_compress(compress)
    hier = resolve_hier(hierarchical, axes)
    dtype = shard.dtype
    kw = dict(block=block, residual=residual)

    def _plain(v, groups):
        return _gather_tiled(v.to(gather_dtype),
                             _flat_group(groups)).to(dtype)

    if hier:
        inner, outer = axes
        if scheme is not None:
            piece, new_res = quantized_all_gather_flat(shard, (outer,), **kw)
            piece = piece.to(dtype)
        else:
            piece, new_res = _plain(shard, (outer,)), residual
        return _plain(piece, (inner,)), new_res
    if scheme is not None:
        if len(axes) > 1:
            full, new_res = quantized_all_gather_flat(shard, (axes[-1],),
                                                      **kw)
            return _plain(full.to(dtype), axes[:-1]), new_res
        full, new_res = quantized_all_gather_flat(shard, axes, **kw)
        return full.to(dtype), new_res
    return _plain(shard, axes), residual
