"""Runnable programs built on the port (``python -m
chattts_tpu_torch.examples.api_server``)."""
