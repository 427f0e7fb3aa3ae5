"""device_idle_pct.mesh: device_idle_pct (metrics/device_idle_pct.py) on a cell of several cards, which
reports mesh_recon_s, not recon_s."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("device_idle_pct", "mesh_recon_s")
