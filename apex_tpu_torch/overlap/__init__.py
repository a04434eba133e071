"""Host/device overlap knobs of the port (counterpart of
``apex_tpu/overlap/__init__.py``'s ``resolve_serve_overlap``; the
gradient-overlap and prefetch knobs of the JAX package are not here)."""

from apex_tpu_torch import _env


def resolve_serve_overlap(per_call=None, *, spec_k=0):
    """Whether the serving engine runs the overlapped round (the decode
    fetch deferred one round, ``ServingEngine._step_overlap``). A per-call
    bool is a demand: True raises with speculative decode engaged
    (``spec_k`` > 0), whose acceptance length depends on token values the
    overlapped planner must not see early; a non-bool raises. The
    ``APEX_SERVE_OVERLAP=1`` preference falls back to the serial round
    under speculation. The engine decides which ``spec_k`` to pass (it
    drops a speculation preference before an overlap demand)."""
    if per_call is not None:
        if not isinstance(per_call, bool):
            raise ValueError(f"overlap= must be True/False/None, "
                             f"got {per_call!r}")
        if per_call and spec_k:
            raise ValueError(
                f"overlap=True cannot be honored with speculative "
                f"decode engaged (spec_decode={spec_k}): acceptance "
                f"length depends on token values, which the overlapped "
                f"round-t+1 planner must never observe early")
        return per_call
    return _env.env_flag("APEX_SERVE_OVERLAP") and not spec_k
