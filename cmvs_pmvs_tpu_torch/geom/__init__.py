from .cameras import (  # noqa: F401
    CameraSet, build_camera_set, project, mult, unit3, get_unit,
    get_paxes, fundamental_matrix, epipolar_distance, triangulate_dlt,
    unproject, level_projection, PROJ_SENTINEL,
)
