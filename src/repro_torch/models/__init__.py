"""The port's models (:func:`build_model`), the counterpart of
``repro/models``."""
from .model import Model, build_model, param_stacks

__all__ = ["Model", "build_model", "param_stacks"]
