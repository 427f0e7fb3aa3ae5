"""Cluster-level scheduling: one `reconstruct` per CMVS cluster."""
from .clusters import (  # noqa: F401
    assign_clusters, discover_options, merge_models, run_clusters,
)
