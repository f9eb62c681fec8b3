"""The plain PyTorch versions of the port's K4 and K2 kernels (ops/)
against the JAX reference on the CPU.  K1 is in test_torch_fused.py; the
CUDA kernels against their plain versions are in test_torch_cuda.py.

- K4 Cholesky solve: plain vs ``chol_solve_pallas(interpret=True)`` at
  n=48 and 96, 2e-4 (as the reference's own kernel test), and the
  skipped-direction rule exactly.
- K2 depth render: plain vs ``depth_from_popup`` and
  ``depth_render_pallas(interpret=True)`` on a 64x96 frame, rtol 1e-4 /
  atol 1e-3 (as the reference's own kernel test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, corridor_K, corridor_inputs,
                           np_tree, spd_system)
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.ops.cholesky_pallas import chol_solve_pallas
from pop_up_slam_tpu.ops.depth_render import depth_render_pallas
from pop_up_slam_tpu.popup import popup as jpp
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.ops import cholesky, depth_render

# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("n", [48, 96])
def test_chol_solve_plain_matches_reference(n):
    S, b = spd_system(n, n)
    x_j = chol_solve_pallas(jnp.asarray(S), jnp.asarray(b), interpret=True)
    x_t = cholesky.chol_solve_plain(torch.as_tensor(S), torch.as_tensor(b))
    assert_close(x_t, x_j, 2e-4, rtol=2e-4, what="x")
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = cholesky.chol_solve.launches
    x_w = cholesky.chol_solve(torch.as_tensor(S), torch.as_tensor(b))
    assert torch.equal(x_w, x_t) and cholesky.chol_solve.launches == before


def test_chol_solve_skips_indefinite_directions():
    S = np.diag(np.array([4.0, -1.0, 9.0], np.float32))
    b = np.array([8.0, 5.0, 27.0], np.float32)
    x_t = cholesky.chol_solve_plain(torch.as_tensor(S), torch.as_tensor(b))
    x_j = chol_solve_pallas(jnp.asarray(S), jnp.asarray(b), interpret=True)
    assert_close(x_t, x_j, 1e-5, what="x")
    np.testing.assert_allclose(x_t.numpy(), [2.0, 0.0, 3.0], atol=1e-5)


# ---------------------------------------------------------------- K2


def _depth_case():
    masks, _, _, _, _ = corridor_inputs(5)           # 96 x 128
    mask = masks[60][16:80, 16:112]                 # 64 x 96 crop
    ref = np.load("pop_up_slam_tpu_torch/data/corridor_ref.npz")
    fx, fy, cx, cy = corridor_K(5)
    K = (fx, fy, cx - 16, cy - 16)
    return mask, K, ref["R"][60], ref["t"][60]


def test_depth_render_plain_matches_reference():
    mask, K, R, t = _depth_case()
    cfg = dict(smooth_radius=3, nms_radius=5, min_cols=6)
    Kj = JK.create(*K)
    res_j = jpp.pop_up(Kj, jnp.asarray(mask), jnp.asarray(R), jnp.asarray(t),
                       jpp.PopupConfig(**cfg))
    res_t = convert.popup_planes_from_numpy(np_tree(res_j), CPU)
    Kt = TK.create(*K, device="cpu")
    d_t = depth_render.depth_render(Kt, res_t, torch.as_tensor(mask),
                                    torch.as_tensor(R), torch.as_tensor(t))
    assert bool(res_t.valid.any())
    d_ref = jpp.depth_from_popup(Kj, res_j, jnp.asarray(mask),
                                 jnp.asarray(R), jnp.asarray(t))
    d_pal = depth_render_pallas(Kj, res_j, jnp.asarray(mask), jnp.asarray(R),
                                jnp.asarray(t), interpret=True)
    assert_close(d_t, d_ref, 1e-3, rtol=1e-4, what="vs depth_from_popup")
    assert_close(d_t, d_pal, 1e-3, rtol=1e-4, what="vs pallas")
