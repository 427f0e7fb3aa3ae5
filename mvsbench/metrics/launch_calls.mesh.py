"""launch_calls.mesh: launch_calls (metrics/launch_calls.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("launch_calls", "mesh_recon_s")
