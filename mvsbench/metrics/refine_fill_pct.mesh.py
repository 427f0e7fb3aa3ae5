"""refine_fill_pct.mesh: refine_fill_pct (metrics/refine_fill_pct.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("refine_fill_pct", "mesh_recon_s")
