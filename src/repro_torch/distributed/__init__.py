"""The port's fault-injection tier: :class:`FaultPlan`."""
from .fault import FaultPlan

__all__ = ["FaultPlan"]
