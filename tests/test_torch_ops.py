"""The plain PyTorch versions of the port's K4 and K2 kernels (ops/)
against the JAX reference on the CPU.  K1 is in test_torch_fused.py; the
CUDA kernels against their plain versions are in test_torch_cuda.py.

- K4 Cholesky solve: plain vs ``chol_solve_pallas(interpret=True)`` at
  n=48 and 96, 2e-4 (as the reference's own kernel test), and the
  skipped-direction rule exactly.  The reference is compiled once, at
  n=96: a smaller system is solved embedded in an identity of that size,
  as the kernel itself pads to its 128-lane tile.
- K2 depth render: plain vs ``depth_from_popup`` and
  ``depth_render_pallas(interpret=True)`` on a 120x160 frame, rtol 1e-4 /
  atol 1e-3 (as the reference's own kernel test).
- The kernel wrappers' shared input gate, on CPU tensors.
"""

import jax
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

_CHOL_N = 96


def _chol_ref(S, b):
    """The reference kernel's solution of S x = b (n <= 96), solved as the
    block-diagonal [[S, 0], [0, I]] system of size 96."""
    n = S.shape[0]
    Sp = np.eye(_CHOL_N, dtype=np.float32)
    Sp[:n, :n] = S
    bp = np.zeros(_CHOL_N, np.float32)
    bp[:n] = b
    return np.asarray(chol_solve_pallas(jnp.asarray(Sp), jnp.asarray(bp),
                                        interpret=True))[:n]


@pytest.mark.parametrize("n", [48, 96])
def test_chol_solve_plain_matches_reference(n):
    S, b = spd_system(n, n)
    x_j = _chol_ref(S, b)
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
    x_j = _chol_ref(S, b)
    assert_close(x_t, x_j, 1e-5, what="x")
    np.testing.assert_allclose(x_t.numpy(), [2.0, 0.0, 3.0], atol=1e-5)


# ---------------------------------------------------------------- K2


_pop_up_jit = jax.jit(jpp.pop_up, static_argnames=("cfg",))


def test_depth_render_plain_matches_reference():
    masks, _, _, _, _ = corridor_inputs(4)           # 120 x 160
    mask = masks[60]
    ref = np.load("pop_up_slam_tpu_torch/data/corridor_ref.npz")
    R, t = ref["R"][60], ref["t"][60]
    K = corridor_K(4)
    cfg = dict(smooth_radius=3, nms_radius=5, min_cols=6)
    Kj = JK.create(*K)
    res_j = _pop_up_jit(Kj, jnp.asarray(mask), jnp.asarray(R), jnp.asarray(t),
                        cfg=jpp.PopupConfig(**cfg))
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


# ---------------------------------------------------------------- wrappers

@pytest.mark.parametrize("case", ["ok", "device", "shape", "dtype",
                                  "contiguity"])
def test_check_inputs(case):
    """The kernel wrappers' input gate (``ops/_build.py::check_inputs``):
    each tensor on the device, of its shape and dtype (float32 unless
    given) and contiguous, else a ValueError that names the fault."""
    from pop_up_slam_tpu_torch.ops._build import check_inputs

    x = torch.zeros(4, 3)
    idx = torch.zeros(4, dtype=torch.int32)
    specs = {"ok": (x, (4, 3)), "device": (x.to("meta"), (4, 3)),
             "shape": (x, (3, 4)), "dtype": (x.double(), (4, 3)),
             "contiguity": (x.t(), (3, 4))}
    want = {"device": "lie on", "shape": "shape", "dtype": "want",
            "contiguity": "contiguous"}
    if case == "ok":
        check_inputs("k", CPU, specs["ok"], (idx, (4,), torch.int32))
        return
    with pytest.raises(ValueError, match=want[case]):
        check_inputs("k", CPU, (idx, (4,), torch.int32), specs[case])


def _csrc_files():
    from pop_up_slam_tpu_torch.ops import _build

    return sorted(p.name for p in _build.CSRC.iterdir() if p.is_file())


@pytest.mark.parametrize("name", _csrc_files())
def test_build_covers_every_kernel_source(name):
    """Every file under ``ops/csrc/`` is a listed source or header, so the
    build's hash covers it, and every ``#include "..."`` in it names a
    listed header: a header left out would let a stale build load."""
    import re

    from pop_up_slam_tpu_torch.ops import _build

    assert name in _build.SOURCES + _build.HEADERS
    text = (_build.CSRC / name).read_text()
    for inc in re.findall(r'^\s*#include\s+"([^"]+)"', text, re.M):
        assert inc in _build.HEADERS, f"{name} includes unlisted {inc}"
