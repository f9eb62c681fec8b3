"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (pop-up, detections, association, landmark store, factors,
the windowed Gauss-Newton solve with the exiting keyframe's marginal,
depth render, full-trajectory smoothing), with every kernel replaced by
its plain version, on any device.  It imports nothing of the program.
"""

import torch as _torch

# Full-f32 numerics: a matmul in TF32 is the control's precision, not the
# reference's.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
