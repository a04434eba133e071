"""The flat-buffer layout of a parameter list (counterpart of
``apex_tpu/optimizers/_fused.py``).

:class:`FlatMeta` holds what the JAX class holds (shapes, dtypes, sizes,
offsets, segment ids) and the same methods: one fp32 buffer per quantity,
per-tensor reductions as one segment sum over it. Fused LAMB's
``one_pass`` plain version and the mixed-precision LAMB's fp32 masters
use it. On CUDA the per-tensor sums are :func:`fixed_order_segment_sum`
(each tensor's part summed by ``torch.sum``): ``index_add_`` adds with
atomics there, in no fixed order. On the CPU they stay ``index_add_``.

The ZeRO helpers (JAX's ``:106-185``) serve the sharded optimizers of
``apex_tpu_torch.contrib.optimizers``: :func:`zero_padded_total`,
:func:`zero_ef_residuals`, :func:`zero_master_shard`,
:func:`zero_grad_shard` and :func:`zero_gather_updates`, whose hops go
through :mod:`apex_tpu_torch.parallel.collectives`, so the compression
and hierarchical knobs apply to ZeRO as to DDP. The shard a rank owns is
``collectives.axes_index``: the rank's place in the flat group, which the
staged hierarchical collectives keep. :class:`ShardLayout` lists one
shard's segments (its part of each tensor, and the padding as segment N)
for the per-tensor sums of the sharded LAMB.
"""

import numpy as np
import torch


class FlatMeta:
    """Metadata of a parameter list; :func:`get_meta` caches one per
    (shapes, dtypes, device)."""

    def __init__(self, params):
        self.shapes = [tuple(p.shape) for p in params]
        self.dtypes = [p.dtype for p in params]
        self.sizes = [p.numel() for p in params]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(
            np.int64)
        self.total = int(self.offsets[-1])
        self.num_tensors = len(params)
        self.device = params[0].device if params else torch.device("cpu")
        self._seg = np.repeat(np.arange(self.num_tensors, dtype=np.int64),
                              self.sizes)
        self._seg_dev = None

    @property
    def seg_ids(self):
        """Each flat element's tensor index, on the parameters' device
        (made once)."""
        if self._seg_dev is None:
            self._seg_dev = torch.from_numpy(self._seg).to(self.device)
        return self._seg_dev

    def flatten(self, params, dtype=torch.float32):
        if not params:
            return torch.zeros((0,), dtype=dtype, device=self.device)
        return torch.cat([p.reshape(-1).to(dtype) for p in params])

    def unflatten(self, flat, dtypes=None):
        """Each tensor's part of ``flat``, shaped and cast (a view where
        the dtype is ``flat``'s)."""
        dtypes = dtypes or self.dtypes
        return [flat[int(off):int(off) + size].view(shape).to(dt)
                for off, size, shape, dt in zip(self.offsets[:-1], self.sizes,
                                                self.shapes, dtypes)]

    def per_tensor_sq_norms(self, flat):
        """Each tensor's sum of squares, one segment sum over ``flat`` (on
        CUDA in a fixed order: :meth:`per_tensor_sums`)."""
        if flat.is_cuda:
            return self.per_tensor_sums(flat * flat)
        return torch.zeros(self.num_tensors, dtype=flat.dtype,
                           device=flat.device).index_add_(0, self.seg_ids,
                                                          flat * flat)

    def per_tensor_sums(self, vals):
        """Each tensor's sum of ``vals`` (a flat ``[total]`` buffer), in a
        fixed order on any device (:func:`fixed_order_segment_sum`)."""
        return fixed_order_segment_sum(
            vals, list(range(self.num_tensors)), self.sizes,
            self.num_tensors)

    def broadcast_per_tensor(self, per_tensor_vals):
        """A ``[num_tensors]`` vector spread back over the flat elements."""
        return per_tensor_vals[self.seg_ids]


def fixed_order_segment_sum(vals, segs, lengths, num_segments):
    """``[num_segments]`` sums of ``vals``, whose consecutive runs of
    ``lengths`` elements belong to segments ``segs`` (each segment at most
    one run): each run summed by ``torch.sum``, so two runs give the same
    bits (``index_add_`` adds with atomics on CUDA)."""
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    keep = [(s, n) for s, n in zip(segs, lengths) if n]
    if not keep:
        return out
    parts = torch.split(vals, [n for _, n in keep])
    idx = torch.tensor([s for s, _ in keep], dtype=torch.long,
                       device=vals.device)
    out[idx] = torch.stack([torch.sum(p) for p in parts])
    return out


_meta_cache = {}


def get_meta(params):
    """The cached :class:`FlatMeta` of a parameter list."""
    key = tuple((tuple(p.shape), str(p.dtype), str(p.device))
                for p in params)
    meta = _meta_cache.get(key)
    if meta is None:
        meta = FlatMeta(params)
        _meta_cache[key] = meta
    return meta


def tree_meta(params):
    """``(meta, names)`` of a dict of parameters: the port's trees are
    dicts keyed by name, so the names stand for JAX's treedef."""
    return get_meta(list(params.values())), list(params)


# --------------------------- ZeRO shard plumbing ---------------------------

def _collectives():
    from apex_tpu_torch.parallel import collectives
    return collectives


def zero_padded_total(total, num_shards):
    return (total + num_shards - 1) // num_shards * num_shards


def zero_ef_residuals(total, num_shards, axis_name, hier, device):
    """Zero ``(g_residual, u_residual)`` of the quantized ZeRO hops on
    ``device``: the grad reduce-scatter's residual is the padded flat
    gradient, ``P`` long (``P / inner`` when ``hier``: only the outer hop
    quantizes), the update all-gather's the rank's update shard, ``P /
    num_shards``."""
    C = _collectives()
    P = zero_padded_total(total, num_shards)
    g_len = P
    if hier:
        g_len = P // C.group_size(C.axes_tuple(axis_name)[0])
    return (torch.zeros(g_len, dtype=torch.float32, device=device),
            torch.zeros(P // num_shards, dtype=torch.float32, device=device))


def _padded_flat(meta, leaves, num_shards):
    P = zero_padded_total(meta.total, num_shards)
    flat = torch.empty(P, dtype=torch.float32, device=leaves[0].device)
    off = 0
    for leaf in leaves:
        n = leaf.numel()
        flat[off:off + n].copy_(leaf.reshape(-1))
        off += n
    flat[off:].zero_()
    return flat


def zero_master_shard(meta, leaves, num_shards, axis_name):
    """This rank's fp32 shard of the flattened, zero-padded parameters.
    Asserts that the group's size is ``num_shards``; the shard's index is
    ``collectives.axes_index``."""
    C = _collectives()
    size = C.axes_size(axis_name)
    assert size == num_shards, (
        f"num_shards ({num_shards}) != the size of the group {size}")
    P = zero_padded_total(meta.total, num_shards)
    shard = P // num_shards
    idx = C.axes_index(axis_name)
    flat = _padded_flat(meta, leaves, num_shards)
    return flat[idx * shard:(idx + 1) * shard].clone()


def zero_grad_shard(meta, leaves_g, num_shards, axis_name, compress=None,
                    hierarchical=None, residual=None):
    """The flat gradients reduce-scattered: this rank's padded shard of
    their SUM (the caller divides for the mean). Returns ``(shard,
    new_residual)`` (the residual contract of
    ``collectives.reduce_scatter_flat``)."""
    flat = _padded_flat(meta, leaves_g, num_shards)
    return _collectives().reduce_scatter_flat(
        flat, axis_name, compress=compress, hierarchical=hierarchical,
        residual=residual)


def zero_gather_updates(meta, upd_shard, axis_name, dtypes,
                        gather_dtype=torch.float32, compress=None,
                        hierarchical=None, residual=None):
    """The updated shards all-gathered into per-tensor updates in
    ``dtypes``: returns ``(updates, new_residual)``; ``gather_dtype``
    governs the uncompressed hops (the reference's ``e5m2_allgather``)."""
    full, new_res = _collectives().all_gather_flat(
        upd_shard, axis_name, compress=compress, hierarchical=hierarchical,
        residual=residual, gather_dtype=gather_dtype)
    return meta.unflatten(full.float()[:meta.total], dtypes), new_res


class ShardLayout:
    """One rank's shard of the padded flat layout: ``start``, ``shard``
    elements, and its runs: consecutive ``(segment, length)`` pairs, a
    segment a tensor (0..N-1) or the padding (N), in order. ``pieces``
    cut each run into :data:`PIECE` elements at most, one K22 block
    each."""

    PIECE = 65536     # csrc/multi_tensor.cu CHUNK

    def __init__(self, sizes, num_shards, index):
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        total = int(offsets[-1])
        P = zero_padded_total(total, num_shards)
        self.num_tensors = len(sizes)
        self.nseg = self.num_tensors + 1
        self.shard = P // num_shards
        self.start = index * self.shard
        end = self.start + self.shard
        bounds = list(offsets) + [P]
        self.runs = []
        for seg in range(self.nseg):
            a, b = max(int(bounds[seg]), self.start), min(int(bounds[seg + 1]),
                                                         end)
            if b > a:
                self.runs.append((seg, b - a))
        starts, lens, segs = [], [], []
        pos = 0
        for seg, n in self.runs:
            for off in range(0, n, self.PIECE):
                starts.append(pos + off)
                lens.append(min(self.PIECE, n - off))
                segs.append(seg)
            pos += n
        self.count = len(starts)
        self._host = (np.array(starts, np.int64), np.array(lens, np.int32),
                      np.array(segs, np.int32),
                      np.searchsorted(np.array(segs, np.int32),
                                      np.arange(self.nseg + 1),
                                      side="left").astype(np.int32))
        self._dev = {}

    def device_arrays(self, device):
        """The pieces' starts (int64), lengths and segments (int32) and each
        segment's first piece (int32 ``[N + 2]``), on ``device`` (made
        once)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(torch.from_numpy(a).to(device)
                                   for a in self._host)
        return self._dev[key]

    def segment_sums(self, vals):
        """``[N + 1]`` sums of a shard-long ``vals`` over each segment, in a
        fixed order (:func:`fixed_order_segment_sum`)."""
        return fixed_order_segment_sum(vals, [s for s, _ in self.runs],
                                       [n for _, n in self.runs], self.nseg)

    def per_element(self, per_segment):
        """A ``[N + 1]`` vector spread over the shard's elements."""
        segs = torch.tensor([s for s, _ in self.runs], dtype=torch.long,
                            device=per_segment.device)
        reps = torch.tensor([n for _, n in self.runs], dtype=torch.long,
                            device=per_segment.device)
        return torch.repeat_interleave(per_segment[segs], reps,
                                       output_size=self.shard)


_layout_cache = {}


def shard_layout(meta, num_shards, index):
    """The cached :class:`ShardLayout` of ``meta``'s shard ``index``."""
    key = (tuple(meta.sizes), num_shards, int(index))
    if key not in _layout_cache:
        _layout_cache[key] = ShardLayout(meta.sizes, num_shards, int(index))
    return _layout_cache[key]
