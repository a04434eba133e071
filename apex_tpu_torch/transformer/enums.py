"""Transformer enums (``AttnMaskType``, copied from
``apex_tpu/transformer/enums.py``)."""

import enum


class AttnMaskType(enum.Enum):
    padding = 1
    causal = 2
