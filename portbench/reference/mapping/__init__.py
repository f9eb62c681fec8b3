from .landmark_store import (  # noqa: F401
    LandmarkStore,
    evict_landmarks,
    insert_landmarks,
    merge_landmarks,
    update_extents,
)
