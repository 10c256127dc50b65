"""The port's data pipeline, the counterpart of ``repro/data``."""
from .pipeline import FileTokens, SyntheticTokens, make_pipeline, place_batch

__all__ = ["FileTokens", "SyntheticTokens", "make_pipeline", "place_batch"]
