from .covariance import Marginals, recover_marginals  # noqa: F401
from .dogleg import dogleg_solve  # noqa: F401
from .gauss_newton import (  # noqa: F401
    SolveStats,
    apply_update,
    gn_solve,
    lm_solve,
    sanitize_step,
)
from .schur import (  # noqa: F401
    SchurSolution,
    inv3x3,
    make_solve_fn,
    solve_dense,
    solve_schur,
)
