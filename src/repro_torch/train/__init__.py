"""The port's training step (:func:`make_train_step`), the counterpart of
``repro/train``."""
from .train_step import make_train_step

__all__ = ["make_train_step"]
