"""seed_s.mesh: seed_s (metrics/seed_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("seed_s", "mesh_recon_s")
