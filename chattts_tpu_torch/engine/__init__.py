"""Subpackage of chattts_tpu_torch."""
