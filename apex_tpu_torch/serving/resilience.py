"""Serving resilience: admission control, deadline shedding and
KV-pressure preemption (counterpart of the knob and counter half of
``apex_tpu/serving/resilience.py``; host side, stdlib only).

* **admission control** (``admit=N`` / ``APEX_SERVE_ADMIT``): a bounded
  submit queue. ``ServingEngine.submit`` returns a :class:`Rejected`
  (reason and a retry-after estimate in ticks) instead of enqueueing
  when the queue is full.
* **deadline shedding** (``shed=`` / ``APEX_SERVE_SHED``): the engine
  drops queued requests that have waited past the TTFT threshold, whose
  SLO can no longer be met (TTFT is at least the wait).
* **KV-pressure preemption** (``preempt=`` / ``APEX_SERVE_PREEMPT``):
  admission reserves the prompt's pages only and decode grows the table;
  a refused grant preempts the running request of lowest priority (its
  pages freed, prefix-cache references released, its stream requeued),
  and re-admission replays the stream through the packed prefill, or
  restores its pages from the host swap tier
  (:mod:`~apex_tpu_torch.serving.kv_tier`).

Knobs: a per-call engine argument is a demand (garbage raises, and
``preempt=True`` raises in the engine when the page pool cannot
guarantee a lone request's progress); an environment value is a
preference (garbage warns once and is ignored). All default off.

The dispatch watchdog and round recovery of the JAX module
(``guarded_dispatch``, ``DispatchFailure``, ``resolve_recover``) are a
later slice.
"""

import dataclasses

from apex_tpu_torch import _env


@dataclasses.dataclass(frozen=True)
class Rejected:
    """The admission refusal ``ServingEngine.submit`` returns under
    admission control: a full queue is load, not an error.
    ``retry_after_ticks`` is queued-ahead over the slot count, a pacing
    hint."""
    reason: str
    retry_after_ticks: int


def resolve_admit(per_call=None):
    """The submit-queue bound: per-call int (>= 1 a bound, 0/False off;
    anything else raises) > ``APEX_SERVE_ADMIT`` (a non-negative int;
    garbage warns once and is ignored) > 0 (unbounded)."""
    if per_call is not None:
        if per_call is False:
            return 0
        if not isinstance(per_call, int) or isinstance(per_call, bool) \
                or per_call < 0:
            raise ValueError(
                f"admit= wants a non-negative int (0 = off) or None, "
                f"got {per_call!r}")
        return per_call
    v = _env.env_nonneg_int("APEX_SERVE_ADMIT")
    return 0 if v is None else v


def _resolve_flag(per_call, env, name):
    if per_call is not None:
        if not isinstance(per_call, bool):
            raise ValueError(
                f"{name}= wants True/False/None, got {per_call!r}")
        return per_call
    v = _env.env_choice(env, ("1", "0"))
    if v is not None:
        return v == "1"
    return False


def resolve_shed(per_call=None):
    """Deadline shedding: per-call bool (a non-bool raises) >
    ``APEX_SERVE_SHED`` > off."""
    return _resolve_flag(per_call, "APEX_SERVE_SHED", "shed")


def resolve_preempt(per_call=None):
    """KV-pressure preemption: per-call bool (a non-bool raises) >
    ``APEX_SERVE_PREEMPT`` > off. The engine judges the progress
    guarantee on top."""
    return _resolve_flag(per_call, "APEX_SERVE_PREEMPT", "preempt")


@dataclasses.dataclass
class ResilienceStats:
    """Engine-lifetime counters of the layers, and their rates (None for
    a layer that is off)."""
    rejected: int = 0
    shed: int = 0
    preempted: int = 0
    resubmitted: int = 0
    degraded_rounds: int = 0
    submit_attempts: int = 0
    admissions: int = 0

    def rates(self, *, shed_on, preempt_on, recover_on=False):
        return {
            "shed_rate": (self.shed / self.submit_attempts
                          if self.submit_attempts else 0.0)
            if shed_on else None,
            "preempt_rate": (self.preempted / self.admissions
                             if self.admissions else 0.0)
            if preempt_on else None,
            "degraded_rounds": self.degraded_rounds
            if recover_on else None,
        }
