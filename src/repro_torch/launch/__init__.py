"""Launch layer of the port: the scatter/gather cluster engine and its
chaos layer.  Device meshes are not part of this package yet."""

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
