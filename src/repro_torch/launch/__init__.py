"""Launch layer of the port: the scatter/gather cluster engine, its chaos
layer, and the LM serving CLI (``serve.py``, run as a module).  Device
meshes are not part of this package yet."""

from repro_torch.launch.cluster import (
    ClusterConfig,
    ClusterEngine,
    ClusterReport,
    ElasticEvent,
    ElasticSchedule,
    FleetController,
    FleetView,
    Worker,
    scatter_gather,
)

__all__ = [
    "ClusterConfig", "ClusterEngine", "ClusterReport", "ElasticEvent",
    "ElasticSchedule", "FleetController", "FleetView", "Worker",
    "scatter_gather",
]
