"""The port's checkpoints (:class:`CheckpointManager`), the counterpart of
``repro/checkpoint``."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
