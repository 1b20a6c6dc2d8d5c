"""Architectures, one module each: what the harness takes from a
configuration's family (``harness/family.py`` says what a module has to
provide)."""
