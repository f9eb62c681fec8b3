from .checkpoint import load_state, save_state  # noqa: F401
from .metrics import MetricsLogger, StageTimer  # noqa: F401
