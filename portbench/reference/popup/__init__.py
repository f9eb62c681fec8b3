from .popup import (  # noqa: F401
    PopupConfig,
    PopupPlanes,
    depth_from_popup,
    pop_up,
    render_depth,
)
