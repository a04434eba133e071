"""Half-precision helpers over parameter trees (counterpart of
``apex_tpu/fp16_utils/fp16util.py``).

A tree is a dict of tensors keyed by dotted parameter names (a new dict
comes back) or an ``nn.Module`` (its parameters and buffers are cast in
place and the module comes back). Norm-layer parameters stay fp32, by
JAX's predicate (``_is_norm_path``): the flax key path a port name stands
for (its dotted parts; the port's modules carry flax's names), joined
with "/" and lowercased, holds "batchnorm", "bn", "norm", "layernorm" or
"groupnorm".
"""

import torch

_NORM_KEY_TOKENS = ("batchnorm", "bn", "norm", "layernorm", "groupnorm")


def _is_norm_path(name):
    """JAX's predicate on the flax key path of the dotted name ``name``."""
    joined = "/".join(str(k).lower() for k in name.split("."))
    return any(tok in joined for tok in _NORM_KEY_TOKENS)


def _cast_tree(tree, dtype_of):
    """Each floating tensor of ``tree`` cast to ``dtype_of(name, t)``
    (None keeps it): a new dict, or the module cast in place."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for name, t in list(tree.named_parameters()) + list(
                    tree.named_buffers()):
                dt = dtype_of(name, t) if t.is_floating_point() else None
                if dt is not None and dt != t.dtype:
                    t.data = t.data.to(dt)
        return tree
    out = {}
    for name, t in tree.items():
        dt = dtype_of(name, t) if t.is_floating_point() else None
        out[name] = t if dt is None else t.to(dt)
    return out


def tofp16(params, half_dtype=torch.float16):
    """Every floating tensor cast to half."""
    return _cast_tree(params, lambda n, t: half_dtype)


def BN_convert_float(params):
    """The norm layers' tensors back to fp32."""
    return _cast_tree(params, lambda n, t: torch.float32
                      if _is_norm_path(n) else None)


def network_to_half(params, half_dtype=torch.float16):
    """A half network with fp32 norms."""
    return BN_convert_float(tofp16(params, half_dtype))


def convert_module(params, dtype):
    """One module's (a subtree's) floating tensors cast to ``dtype``."""
    return _cast_tree(params, lambda n, t: dtype)


def convert_network(params, dtype):
    """The network cast to ``dtype``, its norms kept fp32."""
    return _cast_tree(params, lambda n, t: torch.float32
                      if _is_norm_path(n) else dtype)


class FP16Model:
    """Inputs cast to half and a half network with fp32 norms:
    ``FP16Model(apply_fn)(params, *inputs)`` calls ``apply_fn`` on the
    converted parameters; ``FP16Model(module)(*inputs)`` converts the
    module in place once and calls it."""

    def __init__(self, network, half_dtype=torch.float16):
        self.half_dtype = half_dtype
        self.network = network
        if isinstance(network, torch.nn.Module):
            network_to_half(network, half_dtype)

    def _half(self, x):
        return x.to(self.half_dtype) if torch.is_tensor(x) \
            and x.is_floating_point() else x

    def __call__(self, *args, **kwargs):
        if isinstance(self.network, torch.nn.Module):
            return self.network(*[self._half(x) for x in args], **kwargs)
        params, inputs = args[0], args[1:]
        return self.network(network_to_half(params, self.half_dtype),
                            *[self._half(x) for x in inputs], **kwargs)


def prep_param_lists(params, flat_master=False):
    """``(model_params, master_params)``: fp32 master copies (a dict), or
    with ``flat_master`` one flat fp32 tensor of them all in order."""
    if flat_master:
        return params, torch.cat([p.detach().reshape(-1).float()
                                  for p in params.values()])
    return params, {n: p.detach().float().clone() if p.is_floating_point()
                    else p for n, p in params.items()}


def model_grads_to_master_grads(model_grads, master_params=None,
                                flat_master=False):
    """The (half) gradients upcast to fp32 (flat with ``flat_master``)."""
    del master_params
    if flat_master:
        return torch.cat([g.reshape(-1).float()
                          for g in model_grads.values()])
    return {n: g.float() if g.is_floating_point() else g
            for n, g in model_grads.items()}


def master_params_to_model_params(model_params, master_params,
                                  flat_master=False):
    """The fp32 masters in the model's dtypes: a new dict."""
    if flat_master:
        out, off = {}, 0
        for n, p in model_params.items():
            out[n] = master_params[off:off + p.numel()].view(p.shape).to(
                p.dtype)
            off += p.numel()
        return out
    return {n: master_params[n].to(p.dtype) if p.is_floating_point() else p
            for n, p in model_params.items()}


def clip_grad_norm(grads, max_norm, norm_type=2):
    """``(clipped grads, total_norm)``: the global norm of order
    ``norm_type`` of the fp32 gradients and each gradient times
    ``min(max_norm / (total_norm + 1e-6), 1)``, in its dtype (JAX's
    ``contrib.clip_grad.clip_grad_norm_`` math; a new dict)."""
    leaves = list(grads.values())
    if not leaves:
        return dict(grads), torch.zeros((), dtype=torch.float32)
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().amax().float()
                                       for g in leaves]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(g.abs().float() ** norm_type)
             for g in leaves])) ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return {n: (g.float() * coef).to(g.dtype) for n, g in grads.items()}, \
        total


def to_python_float(t):
    """The first element of ``t`` as a Python float (0.0 when empty)."""
    if torch.is_tensor(t):
        return float(t.reshape(-1)[0].item()) if t.numel() else 0.0
    return float(t)
