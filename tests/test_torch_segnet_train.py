"""SegNetLite training in the port (``create_train_state``, ``train_step``,
``save_segnet``) against the JAX package on the CPU.

- ``train_step`` from flax's initial parameters, converted: the loss and
  the gradients against ``jax.value_and_grad`` of the reference's loss
  (the mean ``optax.sigmoid_binary_cross_entropy``) on the same 8 frames
  at 96x128, both with the convolutions in bf16 (the port's forward
  differentiated by autograd): the loss within 1e-5 relative (measured
  2.8e-7), every kernel's gradient within 1e-2 of its largest entry
  (measured 3.4e-3).  The biases' gradients are held instead against the
  same flax module computing in f32 (``SegNetLite(dtype=float32)``),
  within 3e-2 of each gradient's largest entry (measured 1.9e-2), as is
  every gradient: the reference's bf16 bias gradients (a sum over every
  pixel of the batch) lie 0.76-0.96 of their scale from its own f32
  evaluation, the port's within 1.9e-2 of it.  Gradients, not the
  updated parameters: Adam's first step is about ``lr * sign(g)``, so a
  near-zero gradient's sign flips;
- the reference's own gate (``tests/test_models.py:55-81``, its seed 1):
  40 steps on 8 frames at lr 3e-3 take the loss below a quarter of the
  first, and the net segments 2 new frames at IoU > 0.9.  After 40 steps
  the IoU depends on the draws and on the order of the CPU's sums: the
  reference reaches 0.992 / 0.887 / 0.884 from seeds 1 / 2 / 3 on its
  frames (the port from flax's same initial parameters 0.983 / 0.934 /
  0.903), and the port on its frames 0.907-0.987 over seeds 1-3 at 1, 4
  and 8 threads (0.987 at seed 1 on one thread).  The test runs on one
  thread, so its result does not depend on the machine's core count;
- the initializer: flax's ``lecun_normal`` (kernels of standard deviation
  sqrt(1 / fan_in), truncated at twice the draw's scale), zero biases,
  from the seed;
- the checkpoint: ``save_segnet`` writes the committed file's layout
  (the committed checkpoint's parameters written back give its leaves
  bit for bit), and ``load_pretrained_segnet`` reads a trained one back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import CPU
from pop_up_slam_tpu.models import segmentation as jseg
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
from pop_up_slam_tpu_torch.io import synthetic
from pop_up_slam_tpu_torch.models import (
    SegNetLite,
    create_train_state,
    load_pretrained_segnet,
    predict_mask,
    save_segnet,
    train_step,
)
from pop_up_slam_tpu_torch.models.segmentation import DEFAULT_CHECKPOINT

H, W = 96, 128
LOSS_RTOL = 1e-5
KERNEL_GRAD_TOL = 1e-2    # against the reference's bf16 gradients
GRAD_TOL = 3e-2           # against its f32 ones


def _frames(n, seed):
    """n corridor frames at 96x128 (the reference test's world and
    walk), colored with draws from ``seed``: (rgb f32, ground bool)."""
    K = Intrinsics.create(64.0, 64.0, 64.0, 48.0, device=CPU)
    world = synthetic.corridor_world(device=CPU)
    R, t = synthetic.corridor_trajectory(n, device=CPU)
    gen = torch.Generator().manual_seed(seed)
    labels = torch.stack([synthetic.render_frame(K, R[i], t[i], world, H,
                                                 W)[0] for i in range(n)])
    rgb = torch.stack([synthetic.render_rgb(labels[i], generator=gen)
                       for i in range(n)])
    return rgb, labels == synthetic.LABEL_GROUND


def _iou(pred, gt):
    union = int((pred | gt).sum())
    return 1.0 if union == 0 else int((pred & gt).sum()) / union


def _flax_value_and_grad(module, params, rgb, gt):
    def loss_fn(p):
        logits = module.apply(p, rgb.numpy())
        return optax.sigmoid_binary_cross_entropy(
            logits, gt.numpy().astype(np.float32)).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), convert.segnet_state_dict_from_flax(
        jax.tree.map(np.asarray, grads))


def test_train_step_matches_flax_gradients():
    model_j, params_j, _, _ = jseg.create_train_state(
        jax.random.PRNGKey(1), lr=3e-3, image_hw=(H, W))
    rgb, gt = _frames(8, 2)
    loss_j, g_bf16 = _flax_value_and_grad(model_j, params_j, rgb, gt)
    _, g_f32 = _flax_value_and_grad(jseg.SegNetLite(dtype=jnp.float32),
                                    params_j, rgb, gt)
    sd = convert.segnet_state_dict_from_flax(
        jax.tree.map(np.asarray, params_j))
    model = SegNetLite()
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    tx = torch.optim.Adam(params.values(), lr=3e-3)
    loss = train_step(model, params, tx, rgb, gt)
    assert loss.shape == () and torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), loss_j, rtol=LOSS_RTOL)
    for name, p in params.items():
        g = p.grad.numpy()
        assert np.isfinite(g).all(), name
        for ref, tol in ((g_f32, GRAD_TOL), (g_bf16, KERNEL_GRAD_TOL)):
            if ref is g_bf16 and name.endswith("bias"):
                continue
            r = ref[name].numpy()
            np.testing.assert_allclose(g, r, atol=tol * np.abs(r).max(),
                                       err_msg=name)
    # and the step moved every parameter
    for name, p in params.items():
        assert not torch.equal(p.detach(), sd[name]), name


def test_segnet_trains_on_synthetic():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, params, tx = create_train_state(1, lr=3e-3, image_hw=(H, W),
                                               device=CPU)
        rgb, gt = _frames(8, 2)
        losses = [train_step(model, params, tx, rgb, gt) for _ in range(40)]
        rgb2, gt2 = _frames(2, 3)
        iou = _iou(predict_mask(model, params, rgb2), gt2)
    finally:
        torch.set_num_threads(threads)
    loss0, loss = float(losses[0]), float(losses[-1])
    assert loss < 0.25 * loss0, (loss0, loss)
    assert iou > 0.9, iou


def test_initializer_statistics():
    model, params, tx = create_train_state(5, device=CPU)
    assert isinstance(tx, torch.optim.Adam)
    g = tx.param_groups[0]
    assert g["lr"] == 1e-3 and g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
    for name, p in params.items():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p.shape[1] * p.shape[2] * p.shape[3]
        std = (1.0 / fan_in) ** 0.5
        w = p.detach()
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
        if w.numel() >= 4000:      # enough draws for the moments
            assert abs(float(w.mean())) < 0.1 * std, name
            assert abs(float(w.std()) / std - 1.0) < 0.05, name
    same = create_train_state(5, device=CPU)[1]
    other = create_train_state(6, device=CPU)[1]
    for name in params:
        if name.endswith("weight"):
            assert torch.equal(params[name], same[name])
            assert not torch.equal(params[name], other[name])
    with pytest.raises(ValueError):
        create_train_state(0, image_hw=(100, 128), device=CPU)


def test_checkpoint_round_trip(tmp_path):
    _, params, meta = load_pretrained_segnet(device=CPU)
    path = tmp_path / "again.npz"
    save_segnet(path, params, meta)
    with np.load(DEFAULT_CHECKPOINT) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model, params, tx = create_train_state(3, device=CPU)
    rgb, gt = _frames(2, 4)
    train_step(model, params, tx, rgb, gt)
    path = tmp_path / "trained.npz"
    save_segnet(path, params, {"steps": 1})
    model2, params2, meta2 = load_pretrained_segnet(path, device=CPU)
    assert meta2 == {"steps": 1}
    for name, p in params.items():
        assert torch.equal(p.detach(), params2[name]), name
    with torch.no_grad():
        np.testing.assert_array_equal(
            torch.func.functional_call(model, params, (rgb,)).numpy(),
            model2(rgb).numpy())
