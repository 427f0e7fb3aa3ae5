"""write_text_s.mesh: write_text_s (metrics/write_text_s.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("write_text_s", "mesh_recon_s")
