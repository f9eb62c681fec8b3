from .graph import (  # noqa: F401
    Factors,
    Linearization,
    OdomFactors,
    PlaneFactors,
    PosePriors,
    Window,
    linearize,
    total_cost,
)
from .robust import RobustConfig, RobustKernel  # noqa: F401
