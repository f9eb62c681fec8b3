"""pop_up_slam_tpu_torch — the PyTorch/CUDA port of ``pop_up_slam_tpu``.

The JAX package beside this one is the reference; this package mirrors
its layout and names so that every module has a counterpart:

- ``geometry``  : SE(3)/SO(3), planes on S^3, the pinhole camera.
- ``popup``     : single-image pop-up (boundary -> wall planes -> depth).
- ``factors``   : Window/Factors tuples, analytic linearization, IRLS.
- ``solver``    : Schur elimination + Gauss-Newton.
- ``assoc``     : masked plane data association.
- ``mapping``   : fixed-capacity landmark store.
- ``pipeline``  : the per-frame SLAM step and the chunked runner.
- ``ops``       : hand-written CUDA kernels for the H100 (fused GN,
                  depth render, Cholesky), each beside its plain
                  PyTorch version.
- ``convert``   : numpy <-> port state conversion.
- ``io``, ``evaluation``, ``models``, ``utils``, ``runners``,
  ``config``, ``cli`` : TUM sequences (and a PNG codec), the synthetic
  world, ATE/RPE, the classical segmenter, timing and checkpoints, the
  TUM runner, the five presets and the command line.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
or CPU tensors; without a GPU they raise instead of silently running on
the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-f32 numerics, the counterpart of the reference's forced float32
# matmul precision: SE(3) composition and Jacobian assembly lose ~1e-3
# relative accuracy in TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
