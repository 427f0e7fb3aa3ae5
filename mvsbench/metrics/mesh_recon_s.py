"""mesh_recon_s: recon_s (metrics/recon_s.py) on a cell of several
cards: the window's wall time over the jobs completed in it, each job
ending when the last rank returns (host clock). Apart from recon_s for
its own bound: the mesh's runs spread wider."""
from mvsbench.readers import twin

UNIT, LAYER, MOVES, read = twin("recon_s", None)
