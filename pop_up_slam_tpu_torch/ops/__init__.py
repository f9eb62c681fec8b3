"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version (used for CPU tensors):

- :mod:`fused_gn`      — K1, the whole windowed GN solve in one launch;
- :mod:`depth_render`  — K2, the dense depth render of the pop-up;
- :mod:`cholesky`      — K4, Cholesky factorize + solve (its device
                         routine is also K1's reduced solve);
- :mod:`schur`         — K3a (Schur reduction + damping + mask + Cholesky
                         solve, one launch) and K3b (the sparse Schur
                         product over tiles of whole poses, followed by
                         K4), the LM / dog-leg reduced solve;
- :mod:`plane_jacobians` — K5, the closed-form plane-factor Jacobians;
- :mod:`lm_step`       — K6 and K7, the LM iteration's assembly and its
                         trial step around K5 and K3a;
- :mod:`marginal`      — K8, the exiting keyframe's marginal sqrt-info
                         (its device code is also K1's).

Kernels are built from ``csrc/`` at first use (:mod:`._build`); nothing
is compiled or loaded at import.
"""

from . import (  # noqa: F401
    cholesky,
    depth_render,
    fused_gn,
    lm_step,
    marginal,
    plane_jacobians,
    schur,
)
from .cholesky import chol_solve, chol_solve_plain  # noqa: F401
from .fused_gn import (  # noqa: F401
    fused_gn_plain,
    fused_gn_solve,
    fused_gn_supported,
    pack_marg,
)
from .marginal import exiting_marginal, marginal_sqrt  # noqa: F401
from .plane_jacobians import plane_terms, plane_terms_analytic  # noqa: F401
from .schur import (  # noqa: F401
    schur_gemm,
    schur_reduce,
    schur_reduce_plain,
    schur_reduce_small,
)
