from .gauss_newton import (  # noqa: F401
    SolveStats,
    apply_update,
    gn_solve,
    lm_solve,
    sanitize_step,
)
from .schur import SchurSolution, inv3x3, make_solve_fn, solve_schur  # noqa: F401
