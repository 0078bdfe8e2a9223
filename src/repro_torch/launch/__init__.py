"""Launch layer of the port: the scatter/gather cluster engine, its chaos
layer, device meshes (``mesh.py``) and the sharding rules on them
(``sharding.py``), the elastic trainer (``elastic.py``), and the LM serving
and training CLIs (``serve.py`` and ``train.py``, run as modules; the
training CLI runs on one device or on a mesh), and the dry run
(``dryrun.py``, run as a module: every arch x shape x mesh cell's step on
fake tensors and torch's fake process group, no card needed)."""

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
