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
as in JAX; ``compress`` and ``hierarchical`` (JAX's
``parallel/collectives.py``) are not ported yet and raise.
"""

import warnings

import torch
import torch.distributed as dist

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


def _refuse_scale_out(compress, hierarchical):
    if compress not in (None, False) or hierarchical not in (None, False):
        raise NotImplementedError(
            "allreduce_gradients: compress and hierarchical reduction live "
            "in apex_tpu/parallel/collectives.py, which the port has not "
            "ported yet; pass None or False")


def _scalar(value, like):
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def allreduce_gradients(grads, group=None, gradient_average=True,
                        allreduce_always_fp32=False,
                        gradient_predivide_factor=1.0, *, compress=None,
                        hierarchical=None):
    """The gradients (a dict of tensors) reduced over ``group``: the mean
    (or, without ``gradient_average``, the sum), fp32 during the
    reduction with ``allreduce_always_fp32``, divided by
    ``gradient_predivide_factor`` before it and by world / factor after.
    One flat all-reduce per dtype; returns a new dict in the input dtypes.
    Without an initialized process group the world is 1 and the
    gradients come back as they are."""
    _refuse_scale_out(compress, hierarchical)
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
            flat = flat / _scalar(pre, flat).to(dt)
        dist.all_reduce(flat, group=group)
        if gradient_average:
            post = world / pre if pre != 1.0 else world
            flat = flat / _scalar(post, flat).to(dt)
        elif pre != 1.0:
            flat = flat * _scalar(pre, flat).to(dt)
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
    return t / _scalar(world, t).to(t.dtype)


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
        _refuse_scale_out(compress, hierarchical)
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

    def average_gradients(self, grads):
        return allreduce_gradients(
            grads, self.process_group,
            gradient_average=self.gradient_average,
            allreduce_always_fp32=self.allreduce_always_fp32,
            gradient_predivide_factor=self.gradient_predivide_factor)

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
