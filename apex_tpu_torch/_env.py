"""Environment-knob parsers the port needs (a private copy of
``apex_tpu/dispatch/tiles.py`` ``env_int`` / ``env_choice``).

An environment knob is a preference, never a demand: an unset or empty
variable gives None, and a set-but-unparseable value warns once per
(knob, value) and is ignored. Per-call arguments raise instead.
"""

import os
import warnings

_warned_env = set()


def _warn_once(name, value, what):
    if (name, value) not in _warned_env:
        warnings.warn(f"{name}={value!r} {what} — ignored "
                      f"(preference semantics)")
        _warned_env.add((name, value))


def env_int(name):
    """Positive-int knob: the value, or None when unset or garbage."""
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    if v.isdigit() and int(v) > 0:
        return int(v)
    _warn_once(name, v, "is not a positive integer")
    return None


def env_choice(name, allowed):
    """Enumerated knob: the value when it is in ``allowed``, else None."""
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    if v in allowed:
        return v
    _warn_once(name, v, f"is not one of {sorted(allowed)}")
    return None
