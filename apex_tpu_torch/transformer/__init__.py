"""Transformer runtime (counterpart of ``apex_tpu.transformer``)."""
