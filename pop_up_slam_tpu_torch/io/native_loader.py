"""ctypes bindings for the port's native C++ data-loader runtime.

Port of ``pop_up_slam_tpu/io/native_loader.py``.  The runtime under
``csrc/`` is a PNG codec on zlib (no libpng: the inflate and the five row
filters are its own), the TUM sequence reader, timestamp association and
a threaded prefetch scheduler that decodes frames ahead of the SLAM loop
on worker threads; ctypes releases the GIL around each call, so decoding
overlaps the Python loop.

The library is built at first use with the host compiler (``g++ -O2
-std=c++17 -fPIC -pthread``, linked against ``libz``) into
``pop_up_slam_tpu_torch/_build/<hash>/libpopup_native.so``, where
``<hash>`` covers the sources and the flags; the build writes a temporary
file and moves it into place, so processes that build at once do not
race.  A failed build or load raises: nothing falls back to Python
(:mod:`.png` is the codec's plain version, which the tests hold it
against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("png_codec.cc", "tum_loader.cc", "api.cc")
HEADERS = ("png_codec.h", "tum_loader.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra")
LIBS = ("-lz",)
_ERR_LEN = 512

_lib = None


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader cannot be built")
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = Path(tmp) / out.name
        cmd = [cxx, *CXX_FLAGS, "-shared",
               *[str(CSRC / s) for s in SOURCES], "-o", str(so), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native loader failed:\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(so, out)


def library() -> ctypes.CDLL:
    """The loaded native library, built from ``csrc/`` on first use."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _source_hash()
    so = out_dir / "libpopup_native.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        _compile(so)
    lib = ctypes.CDLL(str(so))

    c_char_p, c_void_p = ctypes.c_char_p, ctypes.c_void_p
    c_int, c_long, c_double = ctypes.c_int, ctypes.c_long, ctypes.c_double
    ip = ctypes.POINTER(c_int)
    dp = ctypes.POINTER(c_double)
    sigs = {
        "popup_png_info": (c_int, [c_char_p, ip, ip, ip, ip, c_char_p,
                                   c_int]),
        "popup_png_decode": (c_int, [c_char_p, c_void_p, c_long, ip, ip, ip,
                                     ip, c_char_p, c_int]),
        "popup_png_encode": (c_int, [c_char_p, c_void_p, c_int, c_int, c_int,
                                     c_int, c_char_p, c_int]),
        "popup_seq_open": (c_void_p, [c_char_p, c_char_p, c_int]),
        "popup_seq_close": (None, [c_void_p]),
        "popup_seq_num_rgb": (c_int, [c_void_p]),
        "popup_seq_num_depth": (c_int, [c_void_p]),
        "popup_seq_num_gt": (c_int, [c_void_p]),
        "popup_seq_has_seg": (c_int, [c_void_p]),
        "popup_seq_stamps": (c_int, [c_void_p, c_int, dp, c_int]),
        "popup_seq_gt": (c_int, [c_void_p, dp, c_int]),
        "popup_seq_rgb_path": (c_int, [c_void_p, c_int, c_char_p, c_int]),
        "popup_associate": (c_int, [dp, c_int, dp, c_int, c_double, ip,
                                    c_int]),
        "popup_prefetch_start": (c_int, [c_void_p, ip, c_int, c_int, c_int,
                                         c_char_p, c_int]),
        "popup_prefetch_next_info": (c_int, [c_void_p, ip, ip, ip, ip, dp,
                                             c_char_p, c_int]),
        "popup_prefetch_next_copy": (c_int, [c_void_p, c_void_p, c_long,
                                             c_char_p, c_int]),
        "popup_prefetch_stop": (None, [c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def _err_buf():
    return ctypes.create_string_buffer(_ERR_LEN)


def _raise(err) -> None:
    raise RuntimeError(err.value.decode() or "native loader error")


def _image(h: int, w: int, c: int, bd: int) -> np.ndarray:
    return np.empty((h, w, c), np.uint16 if bd == 16 else np.uint8)


def decode_png(path: str) -> np.ndarray:
    """Decode a PNG file: (H, W) or (H, W, 3) uint8, or (H, W) uint16 for
    16-bit gray (TUM depth)."""
    lib = library()
    w, h, c, bd = (ctypes.c_int() for _ in range(4))
    dims = [ctypes.byref(v) for v in (w, h, c, bd)]
    err = _err_buf()
    p = os.fsencode(path)
    if lib.popup_png_info(p, *dims, err, _ERR_LEN) != 0:
        _raise(err)
    buf = _image(h.value, w.value, c.value, bd.value)
    if lib.popup_png_decode(p, buf.ctypes.data_as(ctypes.c_void_p),
                            buf.nbytes, *dims, err, _ERR_LEN) != 0:
        _raise(err)
    return buf[..., 0] if c.value == 1 else buf


def encode_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8/uint16 gray or (H, W, 3) uint8 RGB as a PNG
    (filter 0, zlib's default level)."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        bd, channels = 16, 1
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (1, 3))):
        bd, channels = 8, 1 if img.ndim == 2 else img.shape[2]
    else:
        raise ValueError(f"PNG: cannot write {img.dtype} {img.shape}")
    err = _err_buf()
    if library().popup_png_encode(
            os.fsencode(path), img.ctypes.data_as(ctypes.c_void_p),
            img.shape[1], img.shape[0], channels, bd, err, _ERR_LEN) != 0:
        _raise(err)


def associate(stamps_a, stamps_b, max_difference: float = 0.02):
    """Greedy nearest-stamp association (the contract of
    ``evaluation.ate.associate``): pairs (i, j), sorted by i."""
    lib = library()
    a = np.ascontiguousarray(stamps_a, np.float64)
    b = np.ascontiguousarray(stamps_b, np.float64)
    cap = min(len(a), len(b))
    out = np.empty((max(cap, 1), 2), np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    n = lib.popup_associate(a.ctypes.data_as(dp), len(a),
                            b.ctypes.data_as(dp), len(b), max_difference,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                            cap)
    if n < 0:
        raise RuntimeError("native associate failed")
    return [(int(i), int(j)) for i, j in out[:min(n, cap)]]


class NativeSequence:
    """A TUM sequence opened through the native loader, with a threaded
    prefetch stream over (a subset of) its rgb frames.  Use it from one
    thread; :meth:`close` (or leaving the ``with`` block) stops a stream
    that is still running and joins its workers."""

    def __init__(self, root: str):
        self._lib = library()
        err = _err_buf()
        self._h = self._lib.popup_seq_open(os.fsencode(root), err, _ERR_LEN)
        if not self._h:
            _raise(err)
        self.root = root

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.popup_seq_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _handle(self):
        if not self._h:
            raise RuntimeError(f"NativeSequence({self.root!r}) is closed")
        return self._h

    # -- metadata ------------------------------------------------------
    @property
    def num_rgb(self) -> int:
        return self._lib.popup_seq_num_rgb(self._handle())

    @property
    def num_gt(self) -> int:
        return self._lib.popup_seq_num_gt(self._handle())

    def stamps(self, kind: str = "rgb") -> np.ndarray:
        k = {"rgb": 0, "depth": 1, "gt": 2}[kind]
        h = self._handle()
        n = (self._lib.popup_seq_num_rgb, self._lib.popup_seq_num_depth,
             self._lib.popup_seq_num_gt)[k](h)
        out = np.empty((max(n, 1),), np.float64)
        got = self._lib.popup_seq_stamps(
            h, k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        return out[:got]

    def gt_poses(self) -> np.ndarray:
        """(N, 7) float64 rows [tx ty tz qx qy qz qw]."""
        n = self.num_gt
        out = np.empty((max(n, 1), 7), np.float64)
        got = self._lib.popup_seq_gt(
            self._handle(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        return out[:got]

    def rgb_path(self, i: int) -> str:
        buf = ctypes.create_string_buffer(4096)
        if self._lib.popup_seq_rgb_path(self._handle(), i, buf, 4096) != 0:
            raise IndexError(i)
        return os.fsdecode(buf.value)

    # -- prefetch stream -----------------------------------------------
    def stream(self, indices=None, num_threads: int = 2,
               lookahead: int = 8) -> Iterator[tuple[float, np.ndarray]]:
        """Yield (stamp, image) in order while ``num_threads`` workers
        decode up to ``lookahead`` frames ahead.  ``indices`` restricts
        and orders the stream to a subset of the frames.  A frame that
        fails to decode raises ``RuntimeError`` when the stream reaches
        it; a stream whose sequence was closed raises at its next frame."""
        lib = self._lib
        err = _err_buf()
        if indices is not None:
            idx = np.ascontiguousarray(indices, np.int32)
            ptr = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
            n_idx = len(idx)
        else:
            ptr, n_idx = None, 0
        if lib.popup_prefetch_start(self._handle(), ptr, n_idx, num_threads,
                                    lookahead, err, _ERR_LEN) != 0:
            _raise(err)
        w, h, c, bd = (ctypes.c_int() for _ in range(4))
        stamp = ctypes.c_double()
        try:
            while True:
                rc = lib.popup_prefetch_next_info(
                    self._handle(), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(c), ctypes.byref(bd), ctypes.byref(stamp),
                    err, _ERR_LEN)
                if rc == 0:
                    return
                if rc < 0:
                    _raise(err)
                buf = _image(h.value, w.value, c.value, bd.value)
                if lib.popup_prefetch_next_copy(
                        self._handle(), buf.ctypes.data_as(ctypes.c_void_p),
                        buf.nbytes, err, _ERR_LEN) != 0:
                    _raise(err)
                yield float(stamp.value), buf[..., 0] if c.value == 1 else buf
        finally:
            if self._h:
                lib.popup_prefetch_stop(self._h)
