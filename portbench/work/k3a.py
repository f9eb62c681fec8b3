"""K3a's work on the inputs of one launch: operations and bytes.

Frozen copy of ``chip_smoke.py``'s count in ``check_k3a``
(``schur_product_ops`` and the ``work`` tuple): the Schur reduction of
the landmarks and the reduced solve at 6W <= 128, whatever kernel
implements it.  The launch's operands are those of
``ops/schur.py::schur_reduce_small``: Hpp (n, n), B and G (n, C) with
n = 6W and C = 3L, the right-hand side and the free-pose mask pm (n,),
and lambda.
"""

from __future__ import annotations

import numpy as np

from .k1 import _chol_ops


def k3a_ops(G, pm) -> float:
    """Operations these operands need: per landmark, the product of its
    B and G rows over the free poses observing it (symmetric: upper
    triangle, depth 3); one subtraction per upper-triangle entry of the
    6x6 blocks those products touch; the damping of the free rows; the
    Cholesky solve of the free rows (``k1._chol_ops``)."""
    n, C = G.shape
    W, L = n // 6, C // 3
    free = (pm.reshape(W, 6)[:, 0] > 0).cpu().numpy()
    obs = (G.reshape(W, 6, L, 3).abs().sum(dim=(1, 3)) > 0).cpu().numpy()
    obs = obs & free[:, None]
    m = 6 * obs.sum(0)
    prod = float((m * (m + 1) // 2 * 2 * 3).sum())
    touched = (obs.astype(np.int64) @ obs.T.astype(np.int64)) > 0
    sub = (21 * int(np.diag(touched).sum())
           + 36 * int(np.triu(touched, 1).sum()))
    n_free = 6 * int(free.sum())
    return prod + sub + n_free + _chol_ops(n_free)


def k3a_bytes(n: int, C: int) -> float:
    """Hpp, B, G, the right-hand side, pm and lambda read once; S and
    the solution written once (f32)."""
    return 4 * (n * n + 2 * n * C + 2 * n + 1) + 4 * (n * n + n)
