"""The traffic is a function of the seed: the same seed gives the same
inputs, another seed other noise over the same set of sizes."""

import os

import numpy as np
import torch

from _portbench_cpu import ROOT  # noqa: F401
from portbench.harness import load_json
from portbench.traffic import generate

CONFIG = {"intrinsics": [40.0, 40.0, 40.0, 30.0], "height": 60, "width": 80}


def _traffic(name, **kw):
    t = load_json(os.path.join(ROOT, "portbench", "traffic", name + ".json"))
    t.update(kw)
    return t


def test_corridor_sequences_by_seed(tmp_path):
    t = _traffic("replay", frames=5, sequences=3, sways=[0.0, 0.1, 0.2])
    a = generate.make(t, CONFIG, 2 ** 31 + 17, "cpu", str(tmp_path))
    b = generate.make(t, CONFIG, 2 ** 31 + 17, "cpu", str(tmp_path))
    c = generate.make(t, CONFIG, 5, "cpu", str(tmp_path))
    for k in ("masks", "odom_R", "odom_t", "R0", "t0"):
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["odom_t"], c["odom_t"])
    assert sorted(a["sway"]) == sorted(c["sway"]) == [0.0, 0.1, 0.2]
    m = a["masks"]
    assert m.shape == (3, 5, 60, 80) and m.any() and not m.all()


def test_tum_tree_by_seed(tmp_path):
    from pop_up_slam_tpu_torch.io import png

    t = _traffic("seq144", frames=4)
    a = generate.make(t, CONFIG, 123456789012, "cpu", str(tmp_path / "a"))
    b = generate.make(t, CONFIG, 123456789012, "cpu", str(tmp_path / "b"))
    files = sorted(os.listdir(os.path.join(a["root"], "rgb")))
    assert len(files) == 4
    for sub in ("rgb", "seg"):
        for f in files:
            with open(os.path.join(a["root"], sub, f), "rb") as fa, \
                    open(os.path.join(b["root"], sub, f), "rb") as fb:
                assert fa.read() == fb.read()
    for i, f in enumerate(files):
        seg = png.read_png(os.path.join(a["root"], "seg", f))
        assert np.array_equal(seg > 127, a["masks"][i])
        rgb = png.read_png(os.path.join(a["root"], "rgb", f))
        assert rgb.shape == (60, 80, 3) and rgb.dtype == np.uint8
    for name in ("rgb.txt", "groundtruth.txt"):
        with open(os.path.join(a["root"], name)) as fa, \
                open(os.path.join(b["root"], name)) as fb:
            assert fa.read() == fb.read()
