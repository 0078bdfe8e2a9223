"""Launch layer of the port: the scatter/gather cluster engine, its chaos
layer, device meshes (``mesh.py``) and the sharding rules on them
(``sharding.py``), the elastic trainer (``elastic.py``), and the LM serving
and training CLIs (``serve.py`` and ``train.py``, run as modules; the
training CLI runs on one device or on a mesh).  The dry run is not part of
this package yet (``ROADMAP.md`` queue 1 item 9)."""

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
from repro_torch.launch.elastic import (
    ElasticTrainer,
    RangeSpec,
    submit_step_ranges,
)
from repro_torch.launch.mesh import (
    dp_axes,
    dp_size,
    make_local_mesh,
    make_production_mesh,
)

__all__ = [
    "ClusterConfig", "ClusterEngine", "ClusterReport", "ElasticEvent",
    "ElasticSchedule", "ElasticTrainer", "FleetController", "FleetView",
    "RangeSpec", "Worker", "dp_axes", "dp_size", "make_local_mesh",
    "make_production_mesh", "scatter_gather", "submit_step_ranges",
]
