"""Launch layer of the port: the scatter/gather cluster engine, its chaos
layer, and the LM serving and training CLIs (``serve.py`` and
``train.py``, run as modules).  Device meshes are not part of this package
yet (``ROADMAP.md`` queue 1 item 8)."""

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
