"""Opt levels, the ``Properties`` option struct and ``initialize``
(counterpart of ``apex_tpu/amp/frontend.py``).

``Properties`` keeps apex's consistency checks in ``__setattr__``; the
O0-O3 presets and :func:`build_policy` map an opt level to a
:class:`~apex_tpu_torch.amp.policy.Policy`. :func:`initialize` takes a
module (or a dict of tensors, as the JAX function takes a pytree), casts
its floating parameters in place to the policy's parameter dtype, keeping
the ones :func:`_default_bn_predicate` calls batch norm in fp32 where the
opt level keeps batch norm fp32, and wraps the optimizer in an
:class:`~apex_tpu_torch.amp.amp_optimizer.AmpOptimizer`.

The batch-norm predicate is JAX's exactly: it reads the parameter's path
joined as ``str`` of flax's ``DictKey`` entries,
``['stage0_block0']/['bn1']/['weight']``, built here from the module
names (which are flax's). In that string ``"/bn"`` never occurs and
``"bn_"`` only in ``bn_init``, so under O2 a ResNet keeps just
``bn_init``'s weight and bias in fp32 and casts its other batch-norm
parameters to the half type, as the JAX package does.
"""

import warnings

import torch

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.amp_optimizer import AmpOptimizer
from apex_tpu_torch.amp.policy import Policy
from apex_tpu_torch.amp.scaler import LossScaler


class Properties(object):
    """Option struct with apex's mutual-consistency checks."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "patch_torch_functions": False,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
            "half_dtype": torch.bfloat16,
            "cast_model_outputs": None,
        }

    def _update_options_dict(self, new_options):
        for k, v in new_options.items():
            if k in self.options:
                self.options[k] = v
            else:
                raise ValueError(f"Tried to set unexpected option {k}")

    def __getattr__(self, name):
        if "options" in self.__dict__:
            options = self.__dict__["options"]
            if name in options:
                return options[name]
        raise AttributeError(f"'Properties' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        if "options" not in self.__dict__:
            super().__setattr__(name, value)
            return
        if name not in self.options:
            raise AttributeError(f"Tried to set unexpected option {name}")
        if name == "cast_model_type":
            if self.opt_level == "O1" and value is not None:
                if value is not False and value != torch.float32:
                    raise RuntimeError(
                        "O1 inserts casts around functions rather than "
                        "casting the model.")
            self.options[name] = value
        elif name == "patch_torch_functions":
            if self.opt_level != "O1" and value:
                raise RuntimeError(
                    "Currently, patch_torch_functions=True should only be "
                    "set by selecting opt_level='O1'.")
            self.options[name] = value
        elif name == "keep_batchnorm_fp32":
            if self.opt_level == "O1" and value is not None:
                raise RuntimeError(
                    "With opt_level O1, batchnorm functions are "
                    "automatically patched to run in fp32, so "
                    "keep_batchnorm_fp32 should be None.")
            if value == "False":
                self.options[name] = False
            elif value == "True":
                self.options[name] = True
            else:
                assert value in (True, False, None), (
                    "keep_batchnorm_fp32 must be a boolean, the string "
                    f"'True' or 'False', or None, found {value}")
                self.options[name] = value
        elif name == "master_weights":
            if self.opt_level == "O1" and value is not None:
                raise RuntimeError(
                    "It doesn't make sense to use master_weights with O1.")
            self.options[name] = value
        elif name == "loss_scale":
            self.options[name] = value if value == "dynamic" \
                else float(value)
        else:
            self.options[name] = value


class O3:
    brief = "O3: Pure half-precision (speed-of-light ceiling)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = "half"
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O2:
    brief = "O2: half casting of the model, with FP32 master weights."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = "half"
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        return properties


class O1:
    brief = "O1: insert automatic casts around safe ops (dtype policy)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O1"
        properties.cast_model_type = None
        properties.patch_torch_functions = True
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = None
        properties.loss_scale = "dynamic"
        return properties


class O0:
    brief = "O0: Pure FP32 training."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = torch.float32
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


opt_levels = {"O3": O3(), "O2": O2(), "O1": O1(), "O0": O0()}


def joined_path(name):
    """A dotted parameter name as JAX's predicate sees its flax path:
    ``"a.b"`` → ``"['a']/['b']"``."""
    return "/".join(f"['{k}']" for k in name.split("."))


def _default_bn_predicate(path):
    """JAX's batch-norm heuristic over a joined path (see the module
    docstring for what it matches)."""
    joined = path.lower()
    return any(tag in joined for tag in ("batchnorm", "batch_norm", "bn_",
                                         "/bn", "batchstats", "batch_stats"))


def cast_plan(names_dtypes, dtype, keep_bn_fp32, bn_predicate):
    """``{name: target dtype}`` for the floating parameters among
    ``names_dtypes`` (name -> dtype) that change dtype."""
    out = {}
    for name, dt in names_dtypes.items():
        if not dt.is_floating_point:
            continue
        want = torch.float32 if keep_bn_fp32 and bn_predicate(
            joined_path(name)) else dtype
        if want != dt:
            out[name] = want
    return out


def build_policy(properties):
    """A ``Properties`` as a ``Policy``; a concrete ``cast_model_type``
    overrides the half dtype."""
    half = properties.half_dtype
    cmt = properties.cast_model_type
    if cmt not in (None, "half", False):
        half = cmt
        if half == torch.float32:
            return Policy()
        return Policy(param_dtype=half, compute_dtype=half,
                      output_dtype=torch.float32,
                      keep_batchnorm_fp32=properties.keep_batchnorm_fp32
                      in (True, None))
    if properties.opt_level == "O3":
        return Policy(param_dtype=half, compute_dtype=half, output_dtype=half,
                      keep_batchnorm_fp32=False)
    if properties.opt_level == "O2":
        return Policy(param_dtype=half, compute_dtype=half,
                      output_dtype=torch.float32,
                      keep_batchnorm_fp32=bool(
                          properties.keep_batchnorm_fp32))
    if properties.opt_level == "O1":
        return Policy(param_dtype=torch.float32, compute_dtype=half,
                      output_dtype=torch.float32, keep_batchnorm_fp32=True)
    return Policy()


def _is_tx(o):
    return hasattr(o, "init") and hasattr(o, "update")


def initialize(model, optimizer=None, opt_level="O1", cast_model_type=None,
               patch_torch_functions=None, keep_batchnorm_fp32=None,
               master_weights=None, loss_scale=None, num_losses=1,
               min_loss_scale=None, max_loss_scale=2.0 ** 24, half_dtype=None,
               bn_predicate=_default_bn_predicate, verbosity=1,
               cast_model_outputs=None):
    """``amp.initialize`` in PyTorch's idiom with JAX's keyword arguments.

    ``model`` is an ``nn.Module`` (its floating parameters cast in place)
    or a dict of tensors (a new dict returned); buffers keep their dtype,
    as JAX's ``batch_stats`` do. ``optimizer`` is a transform of
    :mod:`apex_tpu_torch.optimizers` (or a list of them), wrapped in an
    ``AmpOptimizer``. Returns ``(model, amp_optimizer)``, or ``model``
    without an optimizer. The properties and policy are recorded in
    ``amp._amp_state``."""
    if opt_level not in opt_levels:
        raise RuntimeError(f"Unexpected optimization level {opt_level}.")
    properties = opt_levels[opt_level](Properties())
    _amp_state.maybe_print(
        f"Selected optimization level {opt_level}: "
        f"{opt_levels[opt_level].brief}", verbosity, True)
    for name, value in (("cast_model_type", cast_model_type),
                        ("patch_torch_functions", patch_torch_functions),
                        ("keep_batchnorm_fp32", keep_batchnorm_fp32),
                        ("master_weights", master_weights),
                        ("loss_scale", loss_scale),
                        ("half_dtype", half_dtype),
                        ("cast_model_outputs", cast_model_outputs)):
        if value is not None:
            setattr(properties, name, value)

    policy = build_policy(properties)
    _amp_state.opt_properties = properties
    _amp_state.policy = policy
    _amp_state.verbosity = verbosity

    if policy.param_dtype != torch.float32:
        if isinstance(model, dict):
            plan = cast_plan({n: t.dtype for n, t in model.items()},
                             policy.param_dtype, policy.keep_batchnorm_fp32,
                             bn_predicate)
            model = {n: t.to(plan[n]) if n in plan else t
                     for n, t in model.items()}
        else:
            params = dict(model.named_parameters())
            plan = cast_plan({n: p.dtype for n, p in params.items()},
                             policy.param_dtype, policy.keep_batchnorm_fp32,
                             bn_predicate)
            with torch.no_grad():
                for n, dt in plan.items():
                    params[n].data = params[n].data.to(dt)

    if optimizer is None:
        return model

    scaler = LossScaler(loss_scale=properties.loss_scale,
                        min_loss_scale=min_loss_scale,
                        max_loss_scale=max_loss_scale)
    single = _is_tx(optimizer)
    optimizers = [optimizer] if single else list(optimizer)
    wrapped = [AmpOptimizer(tx, scaler=scaler, num_losses=num_losses,
                            master_weights=bool(properties.master_weights),
                            param_dtype=policy.param_dtype)
               for tx in optimizers]
    _amp_state.loss_scalers = [scaler] * num_losses
    _amp_state.optimizers = wrapped
    return model, (wrapped[0] if single else wrapped)


def state_dict(amp_opt_states=None, destination=None):
    """``{"loss_scaler<i>": {"loss_scale", "unskipped"}}`` over every
    scaler of ``amp_opt_states``, as host numbers."""
    out = {}
    i = 0
    for opt_state in amp_opt_states or []:
        for s in opt_state.scalers:
            out[f"loss_scaler{i}"] = {"loss_scale": s.loss_scale.item(),
                                      "unskipped": s.unskipped.item()}
            i += 1
    return out


def load_state_dict(state_dict_in, amp_opt_states):
    """New states with the saved scalers restored, in order; warns when
    the counts differ."""
    n_saved = len(state_dict_in)
    n_here = sum(len(s.scalers) for s in amp_opt_states)
    if n_saved != n_here:
        warnings.warn(
            f"Loading state_dict containing {n_saved} loss_scalers into an "
            f"amp setup with {n_here} loss_scalers.")
    flat = [state_dict_in[k] for k in sorted(
        state_dict_in, key=lambda k: int(k.replace("loss_scaler", "")))]
    out, i = [], 0
    for opt_state in amp_opt_states:
        new = []
        for s in opt_state.scalers:
            if i < len(flat):
                s = LossScaler.load_state_dict(s, flat[i])
            new.append(s)
            i += 1
        out.append(opt_state.replace(scalers=tuple(new)))
    return out
