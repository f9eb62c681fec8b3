from .popup import (  # noqa: F401
    PopupConfig,
    PopupPlanes,
    depth_from_popup,
    extract_boundaries,
    extract_boundary,
    fit_wall_planes,
    pop_up,
    render_depth,
    segment_boundary,
)
