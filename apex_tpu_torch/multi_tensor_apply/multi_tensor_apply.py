"""Multi-tensor ops over lists of tensors (counterpart of
``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``).

The JAX module flattens each list into one fp32 buffer and lets XLA fuse
the pass; here a list of CUDA tensors takes the hand-written
multi-tensor kernels (``csrc/multi_tensor.cu``, through
:mod:`apex_tpu_torch.ops.multi_tensor`): :func:`multi_tensor_scale` and
:func:`multi_tensor_axpby` launch K12, the norms K13, one launch a group
of tensors; CPU tensors run the plain versions. The return shapes are
JAX's: ``(outs, noop_flag)`` with the flag a 0-d int32 tensor on the
tensors' device, set when a result is not finite. Nothing reads a device
value on the host. An empty list has no device to take, so the functions
that accept one take ``device`` (None means ``cuda``).
"""

import torch

from apex_tpu_torch import default_device
from apex_tpu_torch.ops import multi_tensor


def flatten(tensors, device=None):
    """The raveled tensors concatenated into one 1-D tensor (an empty
    fp32 tensor on ``device`` for an empty list)."""
    if not tensors:
        return torch.zeros((0,), dtype=torch.float32,
                           device=default_device(device))
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat, like):
    """``flat`` split into tensors shaped and typed like ``like``."""
    sizes = [t.numel() for t in like]
    return [piece.reshape(t.shape).to(t.dtype)
            for piece, t in zip(torch.split(flat, sizes), like)]


def _no_flag(device):
    return torch.zeros((), dtype=torch.int32, device=default_device(device))


def multi_tensor_scale(tensor_lists, scale, device=None):
    """``out[i] = in[i] * scale`` in fp32, cast to ``dsts[i]``'s dtype
    (``tensor_lists = [srcs, dsts]``; the dsts give only dtypes), and the
    noop flag, set when a scaled element is not finite. K12 on CUDA."""
    srcs, dsts = tensor_lists
    if not srcs:
        return [], _no_flag(device)
    return multi_tensor.scale(list(srcs), [d.dtype for d in dsts], scale)


def multi_tensor_axpby(tensor_lists, a, b, device=None):
    """``out[i] = a * x[i] + b * y[i]`` in fp32, cast to ``outs_like[i]``'s
    dtype (``tensor_lists = [xs, ys, outs_like]``), and the noop flag, set
    when a result is not finite. K12 on CUDA."""
    xs, ys, outs_like = tensor_lists
    if not xs:
        return [], _no_flag(device)
    return multi_tensor.axpby(list(xs), list(ys),
                              [o.dtype for o in outs_like], a, b)


def multi_tensor_l2norm(tensor_list, device=None):
    """The list's global L2 norm, a 0-d fp32 tensor (0 on ``device`` for
    an empty list). On CUDA K13 sums each tensor's squares, then the
    tensors in order; the CPU sums the flat buffer, as JAX does."""
    if not tensor_list:
        return torch.zeros((), dtype=torch.float32,
                           device=default_device(device))
    if tensor_list[0].is_cuda:
        return multi_tensor.l2norm(list(tensor_list)).total
    flat = flatten(tensor_list).float()
    return torch.sqrt(torch.sum(flat * flat))


def multi_tensor_l2norm_per_tensor(tensor_list, device=None):
    """``(global norm, per-tensor norms [n])``, fp32; K13 on CUDA."""
    if not tensor_list:
        dev = default_device(device)
        return (torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev))
    norms = multi_tensor.l2norm(list(tensor_list))
    return norms.total, norms.per_tensor


def multi_tensor_applier(op, tensor_lists, *args):
    """``op(tensor_lists, *args)``: the shape of apex's
    ``multi_tensor_applier``, minus the noop-flag buffer (the ops return
    their flag)."""
    return op(tensor_lists, *args)


class MultiTensorApply:
    """The shape of apex's chunked applier object. The kernels chunk
    their lists themselves (``ops/multi_tensor_cuda.CHUNK``), so
    ``chunk_size`` is accepted and not used, as in the JAX package."""

    available = True
    warned = False

    def __init__(self, chunk_size=2048 * 32):
        self.chunk_size = chunk_size

    @staticmethod
    def check_avail():
        """None: the substrate is always available."""
        return None

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args):
        del noop_flag_buffer  # the ops return their flag
        return op(tensor_lists, *args)


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def fused_elementwise_update(fn, *trees):
    """Run ``fn`` (fp32 elementwise math) once over all leaves of the given
    trees (dicts or lists of tensors): each tree is flattened into one
    fp32 buffer, ``fn`` gets the buffers and returns a tuple of buffers
    (one per output), and output ``i`` is split back shaped and typed like
    tree ``i``, in the structure of the first tree."""
    leaves = [_leaves(t) for t in trees]
    flats = [flatten(ls).float() for ls in leaves]
    outs = fn(*flats)
    if not isinstance(outs, tuple):
        outs = (outs,)
    first = trees[0]
    result = []
    for out, like in zip(outs, leaves):
        parts = unflatten(out, like)
        result.append(dict(zip(first, parts)) if isinstance(first, dict)
                      else parts)
    return tuple(result) if len(result) > 1 else result[0]
