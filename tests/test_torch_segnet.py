"""The port's learned segmenter (``models/segmentation.py``:
``SegNetLite``, ``predict_mask``, ``load_pretrained_segnet``) against the
reference's flax module with the committed checkpoint
(``models_data/segnet_lite.npz``) on the CPU.

Inputs: synthetic corridor frames at 64x96 rendered by the port from
numpy-seeded draws, handed to both.  The port computes in bf16 with f32
parameters as flax does; the two bf16 evaluations part by accumulation
order only, so:

- logits within ``LOGIT_ATOL + LOGIT_RTOL * |flax|`` (5e-3 (1 + |l|):
  measured 2.1e-3 at most, the median pixel equal);
- masks equal except at pixels whose flax logit lies within
  ``MASK_MARGIN`` (0.05) of the threshold;
- the loader's state dict equal to ``convert.segnet_state_dict_from_flax``
  of flax's own loaded tree, its meta the reference's, a missing file a
  ``FileNotFoundError`` naming the path;
- the reference's recorded logits (``corridor_ref_batched.npz``) held the
  same way, and the reference test's IoU gate (> 0.9) on 96x128 frames.
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, REPO
from pop_up_slam_tpu.models import load_pretrained_segnet as j_load
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.io import synthetic as tsyn
from pop_up_slam_tpu_torch.models import (SegNetLite, load_pretrained_segnet,
                                          predict_mask)

LOGIT_ATOL, LOGIT_RTOL = 5e-3, 5e-3
MASK_MARGIN = 0.05


def frames(n: int, H: int, W: int, seed: int):
    """(rgb (n, H, W, 3) f32, ground truth (n, H, W) bool) of ``n``
    corridor frames, the colour draws from a numpy seed."""
    K = TK.create(H / 1.5, H / 1.5, W / 2, H / 2, device=CPU)
    world = tsyn.corridor_world(device=CPU)
    Rs, ts = tsyn.corridor_trajectory(n + 2, device=CPU)
    rng = np.random.default_rng(seed)
    rgb, gt = [], []
    for i in range(n):
        labels, _ = tsyn.render_frame(K, Rs[i + 1], ts[i + 1], world, H, W)
        rgb.append(tsyn.render_rgb(
            labels, tint_u=torch.as_tensor(rng.random((64, 3)),
                                           dtype=torch.float32),
            noise_n=torch.as_tensor(rng.normal(size=(H, W, 3)),
                                    dtype=torch.float32)))
        gt.append(labels == tsyn.LABEL_GROUND)
    return torch.stack(rgb), torch.stack(gt)


@pytest.fixture(scope="module")
def nets():
    model, params, meta = load_pretrained_segnet(device=CPU)
    j_model, j_params, j_meta = j_load()
    return model, params, meta, j_model, j_params, j_meta


def _hold(logits: np.ndarray, ref: np.ndarray):
    assert logits.shape == ref.shape and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    differ = (logits > 0) != (ref > 0)
    assert (np.abs(ref[differ]) < MASK_MARGIN).all()


def test_logits_and_masks_match_flax(nets):
    model, params, _, j_model, j_params, _ = nets
    rgb, _ = frames(3, 64, 96, seed=0)
    ref = np.asarray(jax.jit(j_model.apply)(j_params, rgb.numpy()))
    with torch.no_grad():
        logits = model(rgb)
    assert logits.dtype == torch.float32
    _hold(logits.numpy(), ref)
    mask = predict_mask(model, params, rgb)
    assert mask.dtype == torch.bool
    assert torch.equal(mask, logits > 0)


def test_recorded_reference_logits(nets):
    ref = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                               "corridor_ref_batched.npz"))
    rgb = torch.as_tensor(ref["segnet_rgb8"]).float() / 255.0
    with torch.no_grad():
        logits = nets[0](rgb).numpy()
    _hold(logits, ref["segnet_logits"])


def test_loader_matches_flax_tree(nets, tmp_path):
    model, params, meta, _, j_params, j_meta = nets
    assert meta == j_meta and meta["min_holdout_iou"] >= 0.9
    sd = convert.segnet_state_dict_from_flax(
        jax.tree.map(np.asarray, j_params))
    assert sd.keys() == params.keys()
    for k, v in sd.items():
        assert params[k].dtype == torch.float32
        assert torch.equal(params[k], v), k
    assert params["convs.0.weight"].shape == (16, 3, 3, 3)
    assert params["convs.6.weight"].shape == (64, 128, 3, 3)
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError, match="none.npz"):
        load_pretrained_segnet(missing, device=CPU)


def test_pretrained_iou_gate(nets):
    """``tests/test_models.py::test_pretrained_checkpoint``'s gate at the
    checkpoint's own 96x128."""
    model, params = nets[:2]
    rgb, gt = frames(4, 96, 128, seed=77)
    pred = predict_mask(model, params, rgb)
    iou = float((pred & gt).sum()) / float((pred | gt).sum())
    assert iou > 0.9, iou


def test_module_shapes():
    net = SegNetLite()
    out = net(torch.rand(2, 16, 24, 3))
    assert out.shape == (2, 16, 24) and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in net.parameters())
