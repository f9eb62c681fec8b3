"""Ground/wall segmentation: the classical floor-color model and the
learned SegNet-lite.

Port of ``pop_up_slam_tpu/models/segmentation.py``:

1. :func:`classical_ground_mask` — a floor-color Gaussian model seeded
   from the bottom image rows, with a column cleanup.
2. :class:`SegNetLite` — the small encoder-decoder, f32 parameters and
   bf16 compute, with :func:`predict_mask` and
   :func:`load_pretrained_segnet`, which reads the committed
   synthetic-trained checkpoint ``models_data/segnet_lite.npz``, and its
   training: :func:`create_train_state` (flax's initializer, Adam) and
   :func:`train_step` (the mean sigmoid binary cross-entropy, the bf16
   forward differentiated by autograd); :func:`save_segnet` writes a
   checkpoint in the committed file's layout.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

# the committed checkpoint, found from this package's own location
DEFAULT_CHECKPOINT = (Path(__file__).resolve().parent.parent.parent
                      / "models_data" / "segnet_lite.npz")


def classical_ground_mask(
    rgb: torch.Tensor,
    seed_frac: float = 0.12,
    mahalanobis_thresh: float = 9.0,
    min_col_run: int = 3,
) -> torch.Tensor:
    """Floor-color segmentation without a CNN.

    rgb: (H, W, 3) float in [0, 1] (or uint8).  Fits a Gaussian color
    model to the bottom-center patch (bottom ``seed_frac`` of rows,
    central half of columns), refines it once on the inliers of the
    lower image half, and labels pixels within a Mahalanobis radius;
    an empty mask when the seed color is not separable from the top
    rows'.  A per-column cleanup keeps a ground pixel only while fewer
    than ``min_col_run`` non-ground pixels lie between it and the ground
    pixel below it (or the bottom edge), as the reference's bottom-up
    scan does.  Returns (H, W) bool, on ``rgb``'s device, without a host
    sync (the 3x3 inverses are ``inv_ex``'s).
    """
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) / 255.0
    H, W, _ = rgb.shape
    dev = rgb.device
    seed_rows = max(int(H * seed_frac), 4)
    seed = rgb[H - seed_rows:, W // 4: (3 * W) // 4, :].reshape(-1, 3)
    eye3 = torch.eye(3, dtype=rgb.dtype, device=dev)

    def fit(pix, w):
        wsum = torch.clamp(w.sum(), min=1.0)
        mu = (pix * w[:, None]).sum(dim=0) / wsum
        centered = (pix - mu) * torch.sqrt(w)[:, None]
        cov = centered.T @ centered / wsum + 1e-4 * eye3
        return mu, torch.linalg.inv_ex(cov)[0]

    def mdist(mu, prec):
        diff = rgb - mu
        return torch.einsum("hwi,ij,hwj->hw", diff, prec, diff)

    mu, prec = fit(seed, torch.ones((seed.shape[0],), device=dev))
    # one robust refit on lower-half inliers of the initial model
    rows = torch.arange(H, device=dev)[:, None]
    inlier = (mdist(mu, prec) < mahalanobis_thresh) & (rows >= H // 2)
    mu, prec = fit(rgb.reshape(-1, 3), inlier.reshape(-1).to(rgb.dtype))
    raw = mdist(mu, prec) < mahalanobis_thresh

    # degeneracy guard: the seed color must separate from the top rows'
    top = rgb[:seed_rows].reshape(-1, 3)
    mu_top, _ = fit(top, torch.ones((top.shape[0],), device=dev))
    dmu = mu - mu_top
    raw = raw & (dmu @ prec @ dmu > 4.0)

    # column cleanup, bottom-up: row k (from the bottom) is kept when it
    # is ground and the run of non-ground rows just below it is shorter
    # than min_col_run; that run is k - 1 - (the last ground row below
    # k), with -1 for none, from a cumulative max
    up = torch.flip(raw, dims=(0,))
    k = torch.arange(H, device=dev)[:, None]
    last = torch.cummax(torch.where(up, k, torch.full_like(k, -1)),
                        dim=0).values
    below = torch.cat([torch.full_like(last[:1], -1), last[:-1]])
    keep = up & (k - 1 - below < min_col_run)
    return torch.flip(keep, dims=(0,))


# ---------------------------------------------------------------------------
# SegNet-lite
# ---------------------------------------------------------------------------


class SegNetLite(nn.Module):
    """Small encoder-decoder for binary ground segmentation.

    The reference's flax module layer for layer: per feature width an
    encoder of two 3x3 'SAME' convolutions with ReLU and a 2x2/2 max-pool;
    per width in reverse a nearest 2x upsampling, the concatenation
    ``[x, skip]`` and one 3x3 convolution with ReLU; a final 1x1
    convolution to one logit.  Parameters are f32 (``convs[k]`` is
    flax's ``Conv_k``); every convolution but the last computes in bf16
    (the bias added to the rounded product, as flax adds it), the last in
    f32.  Fully convolutional: any height and width divisible by
    ``2 ** len(features)``.
    """

    def __init__(self, features: tuple = (16, 32, 64),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        convs, c = [], 3
        for f in self.features:
            convs += [nn.Conv2d(c, f, 3, padding=1), nn.Conv2d(f, f, 3,
                                                              padding=1)]
            c = f
        for f in reversed(self.features):   # input: [upsampled x, skip]
            convs.append(nn.Conv2d(c + f, f, 3, padding=1))
            c = f
        convs.append(nn.Conv2d(c, 1, 1))
        self.convs = nn.ModuleList(convs)

    def _conv(self, k: int, x: torch.Tensor, dtype) -> torch.Tensor:
        conv = self.convs[k]
        y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                     padding=conv.padding)
        return y + conv.bias.to(dtype)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) float in [0, 1] -> logits (B, H, W) f32."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        skips, k = [], 0
        for _ in self.features:
            for _ in range(2):
                x = torch.relu(self._conv(k, x, self.dtype))
                k += 1
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        for skip in reversed(skips):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = torch.cat([x, skip], dim=1)
            x = torch.relu(self._conv(k, x, self.dtype))
            k += 1
        return self._conv(k, x, torch.float32)[:, 0]


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal of variance 1 / fan_in truncated
    at two standard deviations (its stddev divided by 0.8796..., the
    truncated unit normal's)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)


def create_train_state(seed_or_generator, lr: float = 1e-3,
                       image_hw=(120, 160), device=None):
    """A fresh SegNetLite to train: (model, params, tx).

    The kernels are drawn as flax initializes ``nn.Conv`` (LeCun normal,
    truncated) from ``seed_or_generator`` (an int seed or a CPU
    ``torch.Generator``), the biases are zero; ``params`` is the module's
    parameter dict (what :func:`predict_mask` and :func:`train_step`
    take), ``tx`` an Adam over it with ``optax.adam``'s defaults (betas
    0.9, 0.999, eps 1e-8).  ``image_hw`` is the reference's init shape:
    the network is fully convolutional, so it only has to be divisible by
    8.  On ``device`` (default ``cuda``)."""
    if any(int(x) % 8 for x in image_hw):
        raise ValueError(f"image_hw {tuple(image_hw)}: H and W must be "
                         "multiples of 8")
    dev = resolve_device(device)
    gen = (seed_or_generator if isinstance(seed_or_generator,
                                           torch.Generator)
           else torch.Generator().manual_seed(int(seed_or_generator)))
    model = SegNetLite()
    with torch.no_grad():
        for conv in model.convs:
            _lecun_normal_(conv.weight, gen)
            conv.bias.zero_()
    model = model.to(dev).train()
    params = dict(model.named_parameters())
    tx = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8)
    return model, params, tx


def train_step(model: SegNetLite, params, tx, rgb: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """One Adam step on the mean sigmoid binary cross-entropy of the
    ground labels.  rgb (B, H, W, 3) f32 in [0, 1], labels (B, H, W)
    bool; ``params`` and ``tx`` from :func:`create_train_state` (updated
    in place).  Returns the step's loss, a 0-d tensor (no host read)."""
    tx.zero_grad(set_to_none=True)
    logits = torch.func.functional_call(model, params, (rgb,))
    loss = F.binary_cross_entropy_with_logits(logits,
                                              labels.to(logits.dtype))
    loss.backward()
    tx.step()
    return loss.detach()


def predict_mask(model: SegNetLite, params, rgb: torch.Tensor,
                 thresh: float = 0.0) -> torch.Tensor:
    """rgb (B, H, W, 3) -> (B, H, W) bool ground mask.  ``params`` is a
    state dict for ``model`` (``load_pretrained_segnet``'s)."""
    with torch.no_grad():
        return torch.func.functional_call(model, params, (rgb,)) > thresh


def load_pretrained_segnet(path: str | None = None, device=None):
    """Load the committed synthetic-trained SegNetLite checkpoint
    (``models_data/segnet_lite.npz``, written by the reference's
    ``scripts/train_segnet.py``: flax's leaves ``leaf_0..leaf_19`` in
    sorted-key order, bias before kernel per ``Conv_k``, and JSON
    ``__meta__``).  The network is fully convolutional, so it runs at any
    resolution; the checkpoint was trained at 96x128 synthetic renders.
    Returns (model, params, meta) on ``device``: the module carries the
    parameters, ``params`` is its state dict."""
    from ..convert import segnet_state_dict_from_flax

    path = Path(path) if path is not None else DEFAULT_CHECKPOINT
    if not path.exists():
        raise FileNotFoundError(f"SegNetLite checkpoint not found: {path}")
    dev = resolve_device(device)
    with np.load(path) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})
        model = SegNetLite()
        n = 2 * len(model.convs)
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    tree = {"params": {f"Conv_{k}": {"bias": leaves[2 * k],
                                     "kernel": leaves[2 * k + 1]}
                       for k in range(n // 2)}}
    model.load_state_dict(segnet_state_dict_from_flax(tree))
    model = model.to(dev).eval()
    return model, dict(model.state_dict()), meta


def save_segnet(path, params, meta: dict | None = None) -> None:
    """Write a SegNetLite parameter dict as the committed checkpoint is
    laid out (flax's tree, ``utils.checkpoint.save_state``), so that
    :func:`load_pretrained_segnet` reads it back."""
    from ..convert import segnet_flax_tree_from_state_dict
    from ..utils.checkpoint import save_state

    save_state(str(path), segnet_flax_tree_from_state_dict(params), meta)
