"""engine_load_s.mesh: engine_load_s (metrics/engine_load_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("engine_load_s", "mesh_recon_s")
