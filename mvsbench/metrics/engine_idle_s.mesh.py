"""engine_idle_s.mesh: engine_idle_s (metrics/engine_idle_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("engine_idle_s", "mesh_recon_s")
