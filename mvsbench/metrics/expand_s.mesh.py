"""expand_s.mesh: expand_s (metrics/expand_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("expand_s", "mesh_recon_s")
