"""Entry points of the port (``python -m repro_torch.launch.<name>``)."""
