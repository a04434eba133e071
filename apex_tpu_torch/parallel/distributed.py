"""Data-parallel gradient synchronization over ``torch.distributed``
(counterpart of ``apex_tpu/parallel/distributed.py``).

JAX's DDP is a function, :func:`allreduce_gradients`, that a step calls
on gradients it already holds: in the ImageNet step the *unscaled fp32*
gradients, after the overflow check, with the found-inf flag's MAX taken
over the group beside it. So the port does not wrap
``torch.nn.parallel.DistributedDataParallel``, whose hooks reduce the
scaled gradients during backward. What it keeps of JAX's semantics:
the mean over the group (``gradient_average``), ``allreduce_always_fp32``
(upcast before the reduction), and ``gradient_predivide_factor`` (divide
by f before, by world / f after), in the order of JAX's ``reduce_one``,
with one flat all-reduce per dtype group. Divisions are by 0-d device
tensors, so the card divides as JAX does (a host scalar would become a
multiplication by its reciprocal). :func:`broadcast_params` takes rank
0's parameters and buffers. The bucket and stream knobs of
:class:`DistributedDataParallel` are accepted, warned once, and ignored,
as in JAX.

The scale-out knobs route through :mod:`apex_tpu_torch.parallel.
collectives`, as JAX's do: ``compress`` (a per-call scheme, raising on an
unknown one; None consults ``set_grad_compress`` / ``APEX_GRAD_COMPRESS``)
and ``hierarchical`` (per call, raising over a group that is not an
``(inner, outer)`` pair; None consults ``set_hier_allreduce`` /
``APEX_HIER_ALLREDUCE``). With both resolved off the reduction is the one
above; otherwise ``collectives.allreduce_tree`` reduces one flat fp32
buffer, the predivision before it, and ``ef_state`` (from
``collectives.ef_init`` or :meth:`DistributedDataParallel.init_ef_state`)
threads the error-feedback residual: with it the return value is
``(grads, new_ef_state)``.
"""

import warnings

import torch
import torch.distributed as dist

from apex_tpu_torch import device_scalar
from apex_tpu_torch.parallel import collectives

NOOP_KNOBS = ("message_size", "delay_allreduce", "num_allreduce_streams",
              "retain_allreduce_buffers", "allreduce_trigger_params",
              "allreduce_communicators", "gradient_average_split_factor",
              "prof")
_warned = set()


def world_size(group=None):
    """The ranks of ``group`` (the default group for None), 1 when no
    process group is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def allreduce_gradients(grads, group=None, gradient_average=True,
                        allreduce_always_fp32=False,
                        gradient_predivide_factor=1.0, *, compress=None,
                        hierarchical=None, ef_state=None):
    """The gradients (a dict of tensors) reduced over ``group`` (a process
    group, None for the default one, or an ``(inner, outer)`` pair from
    ``collectives.hierarchical_groups``): the mean (or, without
    ``gradient_average``, the sum), fp32 during the reduction with
    ``allreduce_always_fp32``, divided by ``gradient_predivide_factor``
    before it and by world / factor after. With the knobs off, one flat
    all-reduce per dtype; returns a new dict in the input dtypes (and the
    new error-feedback state when ``ef_state`` is given). Without an
    initialized process group the world is 1 and the gradients come back
    as they are."""
    axes = collectives.axes_tuple(group)
    scheme = collectives.resolve_compress(compress)
    hier = collectives.resolve_hier(hierarchical, axes)
    if scheme is not None or hier:
        return _scale_out(grads, axes, scheme, hier, gradient_average,
                          gradient_predivide_factor, ef_state)
    group = collectives._flat_group(axes)
    reduced = _allreduce_flat(grads, group, gradient_average,
                              allreduce_always_fp32,
                              gradient_predivide_factor)
    return reduced if ef_state is None else (reduced, ef_state)


def _scale_out(grads, axes, scheme, hier, gradient_average, pre, ef_state):
    """The compressed or hierarchical route: the predivision, then
    ``collectives.allreduce_tree`` over one flat fp32 buffer, then the
    division by world / factor."""
    pre = pre if pre != 1.0 else None
    scaled = grads if pre is None else {
        n: g / device_scalar(pre, g).to(g.dtype) for n, g in grads.items()}
    reduced, new_ef = collectives.allreduce_tree(
        scaled, axes, mean=False,
        compress=scheme if scheme is not None else False,
        hierarchical=hier, ef_state=ef_state)
    world = collectives.axes_size(axes)
    if gradient_average:
        post = world / pre if pre is not None else world
        reduced = {n: (g / device_scalar(post, g).to(g.dtype)).to(g.dtype)
                   for n, g in reduced.items()}
    elif pre is not None:
        reduced = {n: (g * device_scalar(pre, g).to(g.dtype)).to(g.dtype)
                   for n, g in reduced.items()}
    return reduced if ef_state is None else (reduced, new_ef)


def _allreduce_flat(grads, group, gradient_average, allreduce_always_fp32,
                    gradient_predivide_factor):
    world = world_size(group)
    if world == 1 or not grads:
        return dict(grads)
    names = list(grads)
    groups = {}
    for n in names:
        g = grads[n]
        dt = torch.float32 if allreduce_always_fp32 else g.dtype
        groups.setdefault(dt, []).append(n)
    out = {}
    pre = gradient_predivide_factor
    for dt, members in groups.items():
        flat = torch.cat([grads[n].reshape(-1).to(dt) for n in members])
        if pre != 1.0:
            flat = flat / device_scalar(pre, flat).to(dt)
        dist.all_reduce(flat, group=group)
        if gradient_average:
            post = world / pre if pre != 1.0 else world
            flat = flat / device_scalar(post, flat).to(dt)
        elif pre != 1.0:
            flat = flat * device_scalar(pre, flat).to(dt)
        offset = 0
        for n in members:
            g = grads[n]
            out[n] = flat[offset:offset + g.numel()].view(g.shape).to(
                g.dtype)
            offset += g.numel()
    return {n: out[n] for n in names}


def allreduce_max(flag, group=None):
    """A 0-d flag (bool or number) as its MAX over ``group``, on the
    device (the found-inf flag every rank must agree on)."""
    if world_size(group) == 1:
        return flag
    t = flag.to(torch.float32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return (t[0] > 0) if flag.dtype == torch.bool else t[0].to(flag.dtype)


def allreduce_mean(t, group=None):
    """``t`` averaged over ``group`` (a new tensor)."""
    world = world_size(group)
    if world == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t / device_scalar(world, t).to(t.dtype)


@torch.no_grad()
def broadcast_params(module_or_tensors, group=None, src=0):
    """Rank ``src``'s parameters and buffers written into every rank's, in
    place (a module's, or a dict or list of tensors); returns the
    argument."""
    if world_size(group) == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.parameters()) + list(
            module_or_tensors.buffers())
    elif isinstance(module_or_tensors, dict):
        tensors = list(module_or_tensors.values())
    else:
        tensors = list(module_or_tensors)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)
    return module_or_tensors


class DistributedDataParallel:
    """The configuration of apex's ``DistributedDataParallel``; call
    :meth:`average_gradients` in the step on the gradients it holds.
    ``module`` is kept and called through. The :data:`NOOP_KNOBS` are
    accepted and warned once on a non-default value."""

    def __init__(self, module=None, message_size=10000000,
                 delay_allreduce=False, shared_param=None,
                 allreduce_trigger_params=None, retain_allreduce_buffers=False,
                 allreduce_always_fp32=False, num_allreduce_streams=1,
                 allreduce_communicators=None, gradient_average=True,
                 gradient_predivide_factor=1.0,
                 gradient_average_split_factor=None, prof=False,
                 process_group=None, compress=None, hierarchical=None):
        if shared_param is not None:
            raise ValueError(
                "shared_param is no longer supported as an option.")
        # a per-call demand at construction: an unknown scheme or a
        # hierarchical request over a single group raises here
        self.compress = compress
        self.hierarchical = hierarchical
        collectives.resolve_compress(compress)
        if hierarchical:
            collectives.resolve_hier(hierarchical,
                                     collectives.axes_tuple(process_group))
        self.module = module
        self.process_group = process_group
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        for name, val, default in (
                ("message_size", message_size, 10000000),
                ("delay_allreduce", delay_allreduce, False),
                ("num_allreduce_streams", num_allreduce_streams, 1),
                ("retain_allreduce_buffers", retain_allreduce_buffers, False),
                ("allreduce_trigger_params", allreduce_trigger_params, None),
                ("allreduce_communicators", allreduce_communicators, None),
                ("gradient_average_split_factor",
                 gradient_average_split_factor, None),
                ("prof", prof, False)):
            if val != default and name not in _warned:
                _warned.add(name)
                warnings.warn(
                    f"apex_tpu_torch DDP: `{name}` is a bucketing/stream "
                    "knob; the gradients are reduced in one flat all-reduce "
                    "per dtype after the backward; option ignored.")

    def average_gradients(self, grads, ef_state=None):
        return allreduce_gradients(
            grads, self.process_group,
            gradient_average=self.gradient_average,
            allreduce_always_fp32=self.allreduce_always_fp32,
            gradient_predivide_factor=self.gradient_predivide_factor,
            compress=self.compress, hierarchical=self.hierarchical,
            ef_state=ef_state)

    def init_ef_state(self, grads):
        """The zero error-feedback residual for :meth:`average_gradients`
        under this configuration's resolved knobs (None when compression
        is off)."""
        return collectives.ef_init(grads, self.process_group,
                                   compress=self.compress,
                                   hierarchical=self.hierarchical)

    def broadcast_params(self, module_or_tensors=None):
        return broadcast_params(
            self.module if module_or_tensors is None else module_or_tensors,
            self.process_group)

    def __call__(self, *args, **kwargs):
        if self.module is None:
            raise ValueError(
                "DistributedDataParallel was built without a module")
        return self.module(*args, **kwargs)


class Reducer:
    """User-triggered reduction (apex's ``Reducer``): :meth:`reduce`
    averages a dict of gradients over the group."""

    def __init__(self, module_or_grads_list=None, process_group=None):
        self.module = module_or_grads_list
        self.process_group = process_group

    def reduce(self, grads):
        return allreduce_gradients(grads, self.process_group)
