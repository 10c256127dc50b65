"""The port's training and serving steps (:func:`make_train_step`,
:func:`make_serve_steps`), the counterpart of ``repro/train``."""
from .serve_step import make_serve_steps
from .train_step import build_for_mesh, make_train_step

__all__ = ["build_for_mesh", "make_serve_steps", "make_train_step"]
