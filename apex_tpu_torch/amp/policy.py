"""Dtype policies and cast combinators (counterpart of
``apex_tpu/amp/policy.py``).

The JAX package replaces apex's O1 monkey-patching with an explicit
policy — (param, compute, output) dtypes — that its layers consult, and
with cast combinators for user functions. This is the same design over
torch dtypes. It is not ``torch.autocast``, whose op lists differ: the
port's layers read :func:`compute_dtype` or take a ``dtype`` as the JAX
layers do. The cast lists name abstract op categories and are the JAX
package's sets.
"""

import contextlib
import functools
import threading

import torch

FP16_FUNCS = {
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "conv_tbc", "linear", "matmul", "mm", "bmm", "addmm",
    "addbmm", "baddbmm", "dot", "einsum", "prelu", "mv", "dot_general",
}

FP32_FUNCS = {
    "softmax", "log_softmax", "gelu", "tanh", "sigmoid", "erf", "erfinv",
    "exp", "expm1", "log", "log10", "log2", "log1p", "cosh", "sinh", "acos",
    "asin", "atan", "reciprocal", "rsqrt", "pow", "norm", "prod", "sum",
    "cumsum", "cumprod", "mean", "var", "std", "renorm", "dist",
    "layer_norm", "group_norm", "batch_norm", "instance_norm",
    "nll_loss", "cross_entropy", "l1_loss", "mse_loss", "smooth_l1_loss",
    "kl_div", "poisson_nll_loss", "cosine_embedding_loss",
    "hinge_embedding_loss", "margin_ranking_loss", "multilabel_margin_loss",
    "soft_margin_loss", "triplet_margin_loss", "multi_margin_loss",
    "softmin", "softplus",
}

CASTS = {
    "add", "addcdiv", "addcmul", "atan2", "cross", "bilinear", "div", "mul",
    "dot_product", "equal", "ge", "gt", "le", "lt", "ne", "sub",
    "true_divide",
}

SEQUENCE_CASTS = {"cat", "stack", "concatenate"}

BANNED_FUNCS = {
    "binary_cross_entropy": (
        "apex_tpu_torch.amp does not work out-of-the-box with "
        "binary_cross_entropy on half inputs. Use a sigmoid-fused cross "
        "entropy (F.binary_cross_entropy_with_logits) on fp32 logits, or "
        "decorate your loss with @amp.float_function.")
}


class Policy:
    """(param, compute, output) dtypes and the batch-norm rule of an opt
    level; built by ``amp.frontend.build_policy``."""

    def __init__(self, param_dtype=torch.float32,
                 compute_dtype=torch.float32, output_dtype=torch.float32,
                 keep_batchnorm_fp32=True, cast_inputs=None, enabled=True):
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype
        self.keep_batchnorm_fp32 = keep_batchnorm_fp32
        self.cast_inputs = cast_inputs
        self.enabled = enabled

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast_floating(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast_floating(tree, self.output_dtype)

    def __repr__(self):
        def name(d):
            return str(d).replace("torch.", "")

        return (f"Policy(param={name(self.param_dtype)}, "
                f"compute={name(self.compute_dtype)}, "
                f"output={name(self.output_dtype)}, "
                f"keep_bn_fp32={self.keep_batchnorm_fp32})")


def _is_floating(x):
    return torch.is_tensor(x) and x.is_floating_point()


def _cast_floating(tree, dtype):
    """Every floating tensor in a nest of tuples, lists and dicts cast to
    ``dtype``; everything else as it is."""
    if _is_floating(tree):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current_policy():
    """The innermost active policy, or None outside any autocast region."""
    s = _stack()
    return s[-1] if s else None


def compute_dtype(default=torch.float32):
    """The dtype the port's layers compute matmul-class ops in."""
    p = current_policy()
    if p is None or not p.enabled:
        return default
    return p.compute_dtype


@contextlib.contextmanager
def autocast(policy=None, enabled=True, dtype=torch.bfloat16):
    """Activate ``policy`` for the block (the O1 region); with none, one
    that computes matmul-class ops in ``dtype`` over fp32 parameters."""
    if policy is None:
        policy = Policy(param_dtype=torch.float32, compute_dtype=dtype,
                        output_dtype=torch.float32, enabled=enabled)
    _stack().append(policy)
    try:
        yield policy
    finally:
        _stack().pop()


@contextlib.contextmanager
def disable_casts():
    """Run the block with casts off (fp32 compute)."""
    p = current_policy()
    disabled = Policy(enabled=False) if p is None else Policy(
        param_dtype=p.param_dtype, compute_dtype=torch.float32,
        output_dtype=p.output_dtype,
        keep_batchnorm_fp32=p.keep_batchnorm_fp32, enabled=False)
    _stack().append(disabled)
    try:
        yield
    finally:
        _stack().pop()


def _widest_dtype(args):
    dtypes = [a.dtype for a in _leaves(args) if _is_floating(a)]
    if not dtypes:
        return None
    return functools.reduce(torch.promote_types, dtypes)


def half_function(fn):
    """``fn`` with its floating inputs cast to the active compute dtype."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = current_policy()
        if p is None or not p.enabled:
            return fn(*args, **kwargs)
        args, kwargs = _cast_floating((args, kwargs), p.compute_dtype)
        return fn(*args, **kwargs)

    wrapper.__amp_wrapped__ = "half"
    return wrapper


def float_function(fn):
    """``fn`` with its floating inputs cast to fp32 under any policy."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = current_policy()
        if p is None or not p.enabled:
            return fn(*args, **kwargs)
        args, kwargs = _cast_floating((args, kwargs), torch.float32)
        return fn(*args, **kwargs)

    wrapper.__amp_wrapped__ = "float"
    return wrapper


def promote_function(fn):
    """``fn`` with its floating inputs cast to the widest of their
    dtypes."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = current_policy()
        if p is None or not p.enabled:
            return fn(*args, **kwargs)
        widest = _widest_dtype((args, kwargs))
        if widest is not None:
            args, kwargs = _cast_floating((args, kwargs), widest)
        return fn(*args, **kwargs)

    wrapper.__amp_wrapped__ = "promote"
    return wrapper


_user_registries = {"half": [], "float": [], "promote": []}


def register_half_function(module, name):
    setattr(module, name, half_function(getattr(module, name)))
    _user_registries["half"].append((module, name))


def register_float_function(module, name):
    setattr(module, name, float_function(getattr(module, name)))
    _user_registries["float"].append((module, name))


def register_promote_function(module, name):
    setattr(module, name, promote_function(getattr(module, name)))
    _user_registries["promote"].append((module, name))


def lookup_cast(op_name):
    """The cast class of an abstract op: "half", "float", "promote",
    "sequence_promote" or None; raises for a banned op."""
    if op_name in BANNED_FUNCS:
        raise NotImplementedError(BANNED_FUNCS[op_name])
    if op_name in FP16_FUNCS:
        return "half"
    if op_name in FP32_FUNCS:
        return "float"
    if op_name in CASTS:
        return "promote"
    if op_name in SEQUENCE_CASTS:
        return "sequence_promote"
    return None


def cast_for_op(op_name, *args):
    """``args`` cast as the active policy casts them for ``op_name``."""
    p = current_policy()
    if p is None or not p.enabled:
        return args
    kind = lookup_cast(op_name)
    if kind == "half":
        return _cast_floating(args, p.compute_dtype)
    if kind == "float":
        return _cast_floating(args, torch.float32)
    if kind in ("promote", "sequence_promote"):
        widest = _widest_dtype(args)
        return _cast_floating(args, widest) if widest is not None else args
    return args
