"""apex_tpu_torch: the PyTorch + CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
module paths (``serving/model.py`` here is the counterpart of
``apex_tpu/serving/model.py``) and imports ``torch``, never ``jax`` and
nothing of ``apex_tpu``. Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel under ``csrc/``, built at first use by
``ops/_build.py``; its plain PyTorch version sits in the same module and
runs only for tensors that lie on the CPU.

Entry points run on the card unless the caller asks for the CPU:
:func:`default_device` resolves ``device=None`` to ``cuda`` and raises
where CUDA is absent. Importing this package builds and loads nothing.
"""

import torch


def default_device(device=None):
    """The device an entry point runs on: ``cuda`` when ``device`` is None
    (raising if CUDA is absent — no silent CPU fallback), else
    ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def device_scalar(value, like, dtype=torch.float32):
    """``value`` as a 0-d ``dtype`` tensor on ``like``'s device: the
    divisor of every true division by a number. PyTorch turns a division
    of a CUDA tensor by a host number into a multiplication by its
    reciprocal, which rounds differently."""
    return torch.full((), float(value), dtype=dtype, device=like.device)
