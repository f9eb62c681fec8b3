"""The port's native runtime (``io/native_loader.py``, C++ under
``io/csrc/``: a zlib PNG codec, the TUM reader, association and the
threaded prefetch scheduler) against its plain version (``io/png.py``)
and the reference's libpng runtime (``pop_up_slam_tpu/io/native_loader``)
on the CPU.

- encode writes ``io/png.py``'s bytes exactly (one filter-0 IDAT at
  zlib's default level) for 8-bit gray, 8-bit RGB and 16-bit gray, and
  every decode (native, plain, the reference's libpng) returns the
  pixels exactly;
- each of the five row filters alone, 8- and 16-bit, and RGBA and
  gray+alpha (the alpha dropped, as the reference's decoder does) decode
  exactly;
- the committed fixtures written by the reference's libpng codec with
  its adaptive filters (``png_fixture_*.png``: every filter type, 120x160
  RGB and 16-bit gray) decode to their stored pixels;
- ``associate`` equals the reference's, native and Python, on random
  stamps and on ties;
- ``NativeSequence`` over a port-written TUM tree: metadata, ``stream``
  over all frames and over a subset of indices equal to ``io/png.py``'s
  decode of each file; a corrupt frame raises at that frame (no hang);
  closing the sequence mid-stream stops the workers and the stream
  raises at its next frame;
- a missing file, a corrupt chunk and an unreadable format raise; a
  failed build raises.
"""

import os
import struct
import threading
import zlib

import numpy as np
import pytest

from _torch_parity import REPO
from pop_up_slam_tpu.evaluation.ate import associate as j_associate
from pop_up_slam_tpu.io import native_loader as jnl
from pop_up_slam_tpu_torch.evaluation.ate import associate as t_associate
from pop_up_slam_tpu_torch.io import native_loader as nl
from pop_up_slam_tpu_torch.io import png
from pop_up_slam_tpu_torch.io.tum_fixture import write_tum_tree

DATA = os.path.join(REPO, "pop_up_slam_tpu_torch", "data")
TIMEOUT_S = 60


def _images():
    rng = np.random.default_rng(0)
    return {"gray8": rng.integers(0, 256, (23, 31), dtype=np.uint8),
            "rgb8": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
            "gray16": rng.integers(0, 65536, (25, 31), dtype=np.uint16)}


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_codec_matches_plain_and_reference(tmp_path, kind):
    img = _images()[kind]
    p = str(tmp_path / "x.png")
    nl.encode_png(p, img)
    with open(p, "rb") as f:
        assert f.read() == png.encode_png(img)
    for decode in (nl.decode_png, png.read_png, jnl.decode_png):
        out = decode(p)
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(px: np.ndarray, color: int, depth: int, kind: int,
                  width: int) -> bytes:
    """PNG bytes of the scanlines ``px`` (rows, stride) uint8, every row
    written with filter ``kind``."""
    rows, stride = px.shape
    bpp = stride // width
    out, prev = [], np.zeros(stride, np.int64)
    for r in range(rows):
        cur = px[r].astype(np.int64)
        f = np.zeros(stride, np.int64)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) >> 1,
                    _paeth(a, prev[i], c))[kind]
            f[i] = (cur[i] - pred) & 0xFF
        out.append(bytes([kind]) + f.astype(np.uint8).tobytes())
        prev = cur

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, rows, depth,
                                         color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_row_filter(tmp_path, kind):
    imgs = _images()
    rgb = imgs["rgb8"][:9, :11]
    g16 = imgs["gray16"][:9, :11]
    for img, color, depth in ((rgb, 2, 8), (g16, 0, 16)):
        px = (img.astype(">u2").view(np.uint8) if depth == 16
              else img).reshape(img.shape[0], -1)
        p = str(tmp_path / f"f{kind}_{depth}.png")
        with open(p, "wb") as f:
            f.write(_filtered_png(px, color, depth, kind, img.shape[1]))
        np.testing.assert_array_equal(nl.decode_png(p), img)
        np.testing.assert_array_equal(png.read_png(p), img)


@pytest.mark.parametrize("color", [4, 6], ids=["gray_alpha", "rgba"])
def test_alpha_dropped(tmp_path, color):
    rng = np.random.default_rng(3)
    ch = 2 if color == 4 else 4
    img = rng.integers(0, 256, (7, 9, ch), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    with open(p, "wb") as f:
        f.write(_filtered_png(img.reshape(7, -1), color, 8, 4, 9))
    want = img[..., 0] if ch == 2 else img[..., :3]
    np.testing.assert_array_equal(nl.decode_png(p), want)
    np.testing.assert_array_equal(jnl.decode_png(p), want)


@pytest.mark.parametrize("name", ["rgb", "gray16"])
def test_libpng_fixture(name):
    z = np.load(os.path.join(DATA, "png_fixture_pixels.npz"))
    assert set(z[f"{name}_filters"].tolist()) == {0, 1, 2, 3, 4}
    p = os.path.join(DATA, f"png_fixture_{name}.png")
    got = nl.decode_png(p)
    assert got.dtype == z[name].dtype
    np.testing.assert_array_equal(got, z[name])
    np.testing.assert_array_equal(jnl.decode_png(p), z[name])


def test_associate_matches_reference():
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 10, 40))
    b = np.sort(rng.uniform(0, 10, 55))
    got = nl.associate(a, b, 0.1)
    assert got == j_associate(a, b, 0.1) == t_associate(a, b, 0.1)
    assert got == jnl.associate(a, b, 0.1)
    # equal distances: the first candidate in (i, j) order wins
    a, b = np.array([1.0, 2.0]), np.array([1.5])
    assert nl.associate(a, b, 0.6) == j_associate(a, b, 0.6) == [(0, 0)]
    assert nl.associate(a, np.zeros(0), 0.1) == []


@pytest.fixture
def tree(tmp_path):
    """A 10-frame TUM tree written by the port (random RGB frames)."""
    rng = np.random.default_rng(5)
    n, h, w = 10, 24, 32
    root = str(tmp_path / "seq")
    rgb = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    write_tum_tree(root, rng.random((n, h, w)) < 0.5,
                   np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
                   rng.normal(size=(n, 3)).astype(np.float32),
                   100.0 + np.arange(n) / 30.0, rgb=rgb)
    return root, rgb


def _consume(gen, out):
    try:
        for item in gen:
            out.append(item)
    except RuntimeError as e:
        out.append(e)


def _run_bounded(gen):
    """Drain ``gen`` on a thread, failing the test if it hangs."""
    out = []
    th = threading.Thread(target=_consume, args=(gen, out), daemon=True)
    th.start()
    th.join(TIMEOUT_S)
    assert not th.is_alive(), "the stream hung"
    return out


def test_sequence_metadata_and_stream(tree):
    root, rgb = tree
    with nl.NativeSequence(root) as seq:
        assert seq.num_rgb == seq.num_gt == len(rgb)
        np.testing.assert_allclose(seq.stamps("rgb"),
                                   100.0 + np.arange(len(rgb)) / 30.0,
                                   atol=1e-6)
        assert seq.gt_poses().shape == (len(rgb), 7)
        paths = [seq.rgb_path(i) for i in range(len(rgb))]
        got = _run_bounded(seq.stream(num_threads=3, lookahead=2))
        assert len(got) == len(rgb)
        for (stamp, img), p, want in zip(got, paths, rgb):
            np.testing.assert_array_equal(img, want)
            np.testing.assert_array_equal(img, png.read_png(p))
        sel = [7, 1, 8, 1]
        got = _run_bounded(seq.stream(indices=sel, num_threads=2,
                                      lookahead=1))
        assert [float(s) for s, _ in got] == [float(seq.stamps()[i])
                                              for i in sel]
        for (_, img), i in zip(got, sel):
            np.testing.assert_array_equal(img, rgb[i])
        with pytest.raises(IndexError):
            seq.rgb_path(len(rgb))
        with pytest.raises(RuntimeError, match="out of range"):
            next(seq.stream(indices=[0, 99]))


def test_stream_raises_on_corrupt_frame(tree):
    root, rgb = tree
    with nl.NativeSequence(root) as seq:
        bad = seq.rgb_path(4)
    with open(bad, "r+b") as f:         # break the IDAT chunk's CRC
        f.seek(40)
        f.write(b"\x00\x00\x00\x00")
    with nl.NativeSequence(root) as seq:
        got = _run_bounded(seq.stream(num_threads=4, lookahead=8))
    assert len(got) == 5 and isinstance(got[-1], RuntimeError)
    assert "CRC" in str(got[-1]) or "PNG" in str(got[-1])
    for (_, img), want in zip(got[:4], rgb):
        np.testing.assert_array_equal(img, want)


def test_close_mid_stream_stops_workers(tree):
    root, rgb = tree
    seq = nl.NativeSequence(root)
    gen = seq.stream(num_threads=4, lookahead=8)
    np.testing.assert_array_equal(next(gen)[1], rgb[0])
    before = threading.active_count()
    seq.close()                          # joins the workers
    with pytest.raises(RuntimeError, match="closed"):
        next(gen)
    gen.close()
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="closed"):
        seq.num_rgb


def test_errors_raise(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        nl.decode_png(str(tmp_path / "missing.png"))
    with pytest.raises(RuntimeError, match="rgb.txt"):
        nl.NativeSequence(str(tmp_path))
    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(b"not a png at all")
    with pytest.raises(RuntimeError, match="not a PNG"):
        nl.decode_png(p)
    img = _images()["gray8"][:4, :5]
    with open(p, "wb") as f:            # palette (color type 3): refused
        f.write(_filtered_png(img, 3, 8, 0, 5))
    with pytest.raises(RuntimeError, match="unsupported"):
        nl.decode_png(p)
    data = png.encode_png(img)
    with open(p, "wb") as f:            # the image data cut short
        f.write(data[:40] + data[-12:])
    with pytest.raises(RuntimeError):
        nl.decode_png(p)
    with pytest.raises(ValueError):
        nl.encode_png(p, np.zeros((4, 5), np.float32))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(nl.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g..? not found"):
        nl.decode_png(os.path.join(DATA, "png_fixture_rgb.png"))
