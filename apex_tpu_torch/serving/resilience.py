"""Serving resilience: admission control, deadline shedding,
KV-pressure preemption and the dispatch watchdog (counterpart of
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
* **dispatch watchdog and round recovery** (``recover=`` /
  ``APEX_SERVE_RECOVER``): every device dispatch runs under
  a :class:`Watchdog` (:func:`guarded_dispatch` on a reused worker
  thread) waited on with a timeout
  (default ``resilience.SERVE_DISPATCH_TIMEOUT_S``) that turns a hung or
  raising round into a :class:`DispatchFailure` carrying the verdict
  (``wedged`` for a timeout, ``degraded_relay`` for an exception). The
  engine then requeues every unfinished request, zeroes its cache and
  goes on, until ``SERVE_ROUND_ATTEMPTS`` rounds in a row have failed.

Knobs: a per-call engine argument is a demand (garbage raises, and
``preempt=True`` raises in the engine when the page pool cannot
guarantee a lone request's progress); an environment value is a
preference (garbage warns once and is ignored). All default off.
"""

import dataclasses
import queue
import threading
import weakref
from typing import Optional

from apex_tpu_torch import _env
from apex_tpu_torch import resilience as _res


@dataclasses.dataclass(frozen=True)
class Rejected:
    """The admission refusal ``ServingEngine.submit`` returns under
    admission control: a full queue is load, not an error.
    ``retry_after_ticks`` is queued-ahead over the slot count, a pacing
    hint."""
    reason: str
    retry_after_ticks: int


class DispatchFailure(Exception):
    """One failed serving dispatch under the watchdog: ``phase`` names the
    call (``prefill`` | ``decode`` | ``verify``, or the router's
    ``router`` | ``router_probe``), ``verdict`` the classifier's word
    (``wedged`` for a timeout, ``degraded_relay`` for an exception),
    ``detail`` the evidence. ``worker`` is the thread a timed-out call
    still runs on (None otherwise): the engine keeps it, so a test can
    wait for it to wake and see that it launched nothing."""

    def __init__(self, phase, verdict, detail, worker=None):
        super().__init__(f"{phase} dispatch {verdict}: {detail}")
        self.phase = phase
        self.verdict = verdict
        self.detail = detail
        self.worker = worker


class Watchdog:
    """The dispatch watchdog on one long-lived worker thread, reused from
    dispatch to dispatch (the engine's and the router's), so a dispatch
    does not pay for starting a thread (``tests/port/watchdog_cost.py``
    measures both on the card). A call that times out abandons its
    worker, which leaves once that call returns; the next call starts a
    new one. The worker leaves too when the watchdog is collected."""

    def __init__(self, name="serve-dispatch"):
        self.name = name
        self._jobs = self._stop = None
        self.worker = None

    def _start(self):
        jobs = queue.SimpleQueue()

        def loop():
            while True:
                job = jobs.get()
                if job is None:
                    return
                fn, box, done = job
                try:
                    box["result"] = fn()
                except BaseException as e:  # classified, not swallowed
                    box["error"] = e
                # an idle worker holds no call: the engine a call's
                # closure refers to can be collected, and this watchdog
                # with it
                job = fn = box = None
                done.set()

        self.worker = threading.Thread(target=loop, daemon=True,
                                       name=self.name)
        self.worker.start()
        self._jobs = jobs
        self._stop = weakref.finalize(self, jobs.put, None)

    def run(self, fn, timeout_s, phase):
        """``fn()``'s result on a clean return within ``timeout_s``; a
        :class:`DispatchFailure` on a timeout (carrying the abandoned
        worker) or an exception."""
        if self.worker is None:
            self._start()
        box, done = {}, threading.Event()
        self._jobs.put((fn, box, done))
        if not done.wait(timeout_s):
            worker = self.worker
            self._stop()            # it leaves once the late call returns
            self.worker = self._jobs = self._stop = None
            raise DispatchFailure(
                phase, _res.classify_subprocess(None, timed_out=True),
                f"no fetch within the {timeout_s}s round budget "
                f"(resilience.SERVE_DISPATCH_TIMEOUT_S envelope)",
                worker=worker)
        if "error" in box:
            err = box["error"]
            raise DispatchFailure(
                phase, _res.classify_subprocess(1),
                f"{type(err).__name__}: {err}") from err
        return box["result"]


def guarded_dispatch(fn, timeout_s, phase):
    """Run one dispatch ``fn`` (its launches and the fetch of its result,
    no write of engine state) on a worker thread of its own, waited on for
    ``timeout_s`` (JAX's watchdog, a thread a call): its result on a clean
    return within the budget, else :class:`DispatchFailure`. A timed-out
    call's late result is dropped: the caller never adopts it."""
    return Watchdog(f"serve-{phase}-dispatch").run(fn, timeout_s, phase)


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


def resolve_recover(per_call=None):
    """The dispatch watchdog and round recovery: per-call bool (a non-bool
    raises) > ``APEX_SERVE_RECOVER`` > off."""
    return _resolve_flag(per_call, "APEX_SERVE_RECOVER", "recover")


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
    # the last failed round's verdict (round recovery)
    last_verdict: Optional[str] = None

    def rates(self, *, shed_on, preempt_on, recover_on):
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
