"""The port's models: the dense LM family the serving slice runs
(:func:`build_model`), the counterpart of ``repro/models``."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
