"""engine_write_s.mesh: engine_write_s (metrics/engine_write_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("engine_write_s", "mesh_recon_s")
