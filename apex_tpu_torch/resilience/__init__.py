"""Resilience vocabulary of the port (counterpart of the part of
``apex_tpu/resilience/__init__.py`` that serving uses; stdlib only).

* the health verdicts (:data:`VERDICTS`): a dispatch that timed out is
  ``wedged``, one that raised is ``degraded_relay``
  (:func:`classify_subprocess`);
* the serving envelope: the per-round dispatch budget
  (:data:`SERVE_DISPATCH_TIMEOUT_S`), the consecutive failed rounds an
  engine survives (:data:`SERVE_ROUND_ATTEMPTS`) and the pause before it
  drives a failed round again (:data:`SERVE_ROUND_RETRY_WAIT_S`);
* :class:`RetryPolicy`, the attempt budget and retry pacing of JAX's
  attempt state machine: the serving engine paces its failed rounds with
  it, the fleet router its re-admission probes.

:mod:`apex_tpu_torch.resilience.faults` is the fault-injection layer the
chaos tests drive (``APEX_FAULT_PLAN``, tests only). The bench,
checkpoint and flight-recorder parts of the JAX package are not here.
"""

HEALTHY = "healthy"
DEGRADED_RELAY = "degraded_relay"          # the dispatch raised
DEGRADED_LARGE_HBM = "degraded_large_hbm"  # small programs ran, the large
#                                            one starved
WEDGED = "wedged"                          # no result within the budget
IMPLAUSIBLE = "implausible"                # a number past plausibility

VERDICTS = (HEALTHY, DEGRADED_RELAY, DEGRADED_LARGE_HBM, WEDGED,
            IMPLAUSIBLE)

# the serving envelope: a round that has not fetched its result in this
# long is wedged, not slow
SERVE_DISPATCH_TIMEOUT_S = 300   # per-round dispatch budget
SERVE_ROUND_ATTEMPTS = 3         # consecutive failed rounds before the
#                                  engine raises
SERVE_ROUND_RETRY_WAIT_S = 5     # pause before driving a failed round
#                                  again (the chaos tests pin 0)


class RetryPolicy:
    """The attempt state machine's pacing (JAX's ``RetryPolicy`` without
    the bench attempts' wedge cap, which serving does not use): an
    attempt budget and the wait before each retry."""

    def __init__(self, attempts, retry_wait_s):
        self.attempts = max(1, int(attempts))
        self.retry_wait = int(retry_wait_s)
        self.next_wait = self.retry_wait

    def pop_wait(self):
        """The wait before the next retry; resets to the full pause."""
        wait, self.next_wait = self.next_wait, self.retry_wait
        return wait


def classify_subprocess(returncode, timed_out=False):
    """The verdict on an attempt that produced no record: a timeout is
    ``wedged``, a non-zero exit ``degraded_relay``, 0 ``healthy``."""
    if timed_out:
        return WEDGED
    if returncode == 0:
        return HEALTHY
    return DEGRADED_RELAY
