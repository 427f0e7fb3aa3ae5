from .pyramid import PyramidSet, build_pyramids, set_edge  # noqa: F401
from .sample import (  # noqa: F401
    bilinear_at, bilinear_color, edge_at, inside_bimages, mask_all,
)
