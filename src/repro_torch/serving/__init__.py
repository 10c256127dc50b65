"""The port's serving driver: :class:`ServingEngine`."""
from .engine import MAX_WINDOW, P_NODES, PAGE, ServingEngine

__all__ = ["MAX_WINDOW", "P_NODES", "PAGE", "ServingEngine"]
