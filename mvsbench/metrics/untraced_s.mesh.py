"""untraced_s.mesh: untraced_s (metrics/untraced_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("untraced_s", "mesh_recon_s")
