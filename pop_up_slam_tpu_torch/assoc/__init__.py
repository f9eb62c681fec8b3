from .data_association import (  # noqa: F401
    AssocConfig,
    AssocResult,
    associate_detections,
    landmark_scores,
)
