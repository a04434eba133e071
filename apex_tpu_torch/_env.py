"""Environment-knob parsers the port needs (a private copy of
``apex_tpu/dispatch/tiles.py`` ``env_int`` / ``env_nonneg_int`` /
``env_float`` / ``env_choice`` / ``env_flag``).

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


def env_nonneg_int(name):
    """Non-negative-int knob: like :func:`env_int`, but 0 is a legal
    value (the explicit off-pin of count knobs such as
    ``APEX_SPEC_DECODE``); None when unset or garbage."""
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    if v.isdigit():
        return int(v)
    _warn_once(name, v, "is not a non-negative integer")
    return None


def env_float(name, default):
    """Positive-float knob: the parsed value, else ``default`` (an
    unparseable or non-positive value warns once and is ignored)."""
    v = os.environ.get(name)
    if v in (None, ""):
        return float(default)
    try:
        f = float(v)
        if f > 0:
            return f
    except ValueError:
        pass
    _warn_once(name, v, f"is not a positive number (default "
                        f"{float(default):g})")
    return float(default)


def env_choice(name, allowed):
    """Enumerated knob: the value when it is in ``allowed``, else None."""
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    if v in allowed:
        return v
    _warn_once(name, v, f"is not one of {sorted(allowed)}")
    return None


def env_flag(name):
    """Boolean gate: True iff the variable is exactly ``"1"``."""
    return os.environ.get(name) == "1"
