"""The flat-buffer layout of a parameter list (counterpart of
``apex_tpu/optimizers/_fused.py``).

:class:`FlatMeta` holds what the JAX class holds (shapes, dtypes, sizes,
offsets, segment ids) and the same methods: one fp32 buffer per quantity,
per-tensor reductions as one segment sum over it. Fused LAMB's
``one_pass`` plain version and the mixed-precision LAMB's fp32 masters
use it. The ZeRO helpers of the JAX module belong to the sharded
optimizers and are not ported yet.
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
        """Each tensor's sum of squares, one segment sum over ``flat``."""
        return torch.zeros(self.num_tensors, dtype=flat.dtype,
                           device=flat.device).index_add_(0, self.seg_ids,
                                                          flat * flat)

    def broadcast_per_tensor(self, per_tensor_vals):
        """A ``[num_tensors]`` vector spread back over the flat elements."""
        return per_tensor_vals[self.seg_ids]


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
