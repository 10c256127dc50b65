"""The port's distribution layer on the stacked binding: mesh axes
(:mod:`.sharding`), the gradient channel (:mod:`.collectives`), the
expert-parallel MoE block (:mod:`.moe_ep`) and faults (:mod:`.fault`)."""
from .fault import DeviceFailure, ElasticMeshSpec, FaultPlan, run_elastic

__all__ = ["DeviceFailure", "ElasticMeshSpec", "FaultPlan", "run_elastic"]
