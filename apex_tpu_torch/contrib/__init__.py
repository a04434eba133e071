"""apex's contrib tier (counterpart of ``apex_tpu.contrib``): opt-in
submodules, imported on first use. The port holds ``optimizers`` (the
ZeRO-2 optimizers and the compat aliases); JAX's other contrib modules
are not ported yet (ROADMAP)."""


def __getattr__(name):
    import importlib

    if name in ("optimizers",):
        return importlib.import_module(f"apex_tpu_torch.contrib.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch.contrib' has no attribute {name!r}")
