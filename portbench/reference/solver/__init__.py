from .gauss_newton import apply_update, gn_solve, sanitize_step  # noqa: F401
from .schur import SchurSolution, inv3x3, solve_schur  # noqa: F401
