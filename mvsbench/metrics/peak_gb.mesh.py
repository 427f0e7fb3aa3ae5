"""peak_gb.mesh: peak_gb (metrics/peak_gb.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("peak_gb", "mesh_recon_s")
