"""The port's optimizers (:func:`make_optimizer`), the counterpart of
``repro/optim``; gradient compression comes with the distributed
binding."""
from .optimizer import (AdamState, FactoredState, Optimizer,
                        clip_by_global_norm, global_norm, make_optimizer)

__all__ = ["AdamState", "FactoredState", "Optimizer", "clip_by_global_norm",
           "global_norm", "make_optimizer"]
