"""The port's optimizers (:func:`make_optimizer`) and the int8
error-feedback gradient compression (:mod:`.compression`), the counterpart
of ``repro/optim``."""
from .optimizer import (AdamState, FactoredState, Optimizer,
                        clip_by_global_norm, global_norm, make_optimizer)

__all__ = ["AdamState", "FactoredState", "Optimizer", "clip_by_global_norm",
           "global_norm", "make_optimizer"]
