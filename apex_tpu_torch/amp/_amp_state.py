"""Module-level amp state (counterpart of ``apex_tpu/amp/_amp_state.py``).

Holds the selected ``Properties`` and ``Policy``, the verbosity, and the
scalers and optimizers ``initialize`` built. No tensor lives here: the
numerical state is the caller's ``AmpOptState``.
"""

import sys


class AmpState:
    def __init__(self):
        self.hard_override = False
        self.allow_incoming_model_not_fp32 = False
        self.verbosity = 1
        self.opt_properties = None
        self.policy = None
        self.loss_scalers = []
        self.optimizers = []


_amp_state = AmpState()
this = sys.modules[__name__]


def __getattr__(name):
    return getattr(_amp_state, name)


def warn_or_err(msg):
    if _amp_state.hard_override:
        print("Warning: " + msg)
    else:
        raise RuntimeError(msg)


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def maybe_print(msg, verbosity=None, rank0=True):
    """Print ``msg`` unless verbosity is 0 or (with ``rank0``) this is
    not rank 0 of the default process group."""
    v = verbosity if verbosity is not None else _amp_state.verbosity
    if v == 0 or (rank0 and _rank() != 0):
        return
    print(msg)


def master_params(state, params=None):
    """The tensors the optimizer steps, as a list: the fp32 masters of an
    ``AmpOptState`` that keeps them, else ``params`` (a dict or a list of
    the model's parameters, which the caller owns under O1). Raises when
    there is neither, since an empty list would make gradient clipping a
    silent no-op."""
    masters = getattr(state, "master_params", None)
    if masters is None:
        masters = params
    if masters is None:
        raise ValueError(
            "master_params: this opt level keeps no fp32 masters — pass "
            "the model params (master_params(state, params)); yielding "
            "nothing would silently no-op gradient clipping")
    return list(masters.values()) if isinstance(masters, dict) \
        else list(masters)
