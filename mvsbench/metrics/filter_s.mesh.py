"""filter_s.mesh: filter_s (metrics/filter_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("filter_s", "mesh_recon_s")
