"""Runnable demos of the port, the counterparts of the repository's
``examples/``: ``python -m repro_torch.examples.<name> [--device cpu]``."""
