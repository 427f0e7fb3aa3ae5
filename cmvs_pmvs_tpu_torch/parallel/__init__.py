"""Multi-rank execution: cluster scheduling (clusters), the view-parallel
refine step (sharding), the data-parallel engine (engine_shard) and the
cross-cluster halo exchange (cross_cluster), over torch.distributed
(comm)."""
from .clusters import (  # noqa: F401
    assign_clusters, discover_options, merge_models, run_clusters,
)
from .sharding import make_mesh, sharded_refine_step  # noqa: F401
