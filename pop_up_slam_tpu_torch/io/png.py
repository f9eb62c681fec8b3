"""A small PNG reader and writer in Python on the standard library's ``zlib``.

The plain version of the port's native codec (:mod:`.native_loader`,
C++ on zlib), which the tests hold it against; nothing else in the
package uses it.  It reads and writes the formats the runner and the
fixture use: 8-bit gray, 8-bit RGB and 16-bit gray, not interlaced.
Reading undoes the five row filters (0-4), the Average and Paeth rows in
a Python loop (about 0.6 s for a 480x640 RGB frame); writing uses
filter 0 on every row."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}     # color type -> channels (gray, RGB)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int):
    """The reconstructed scanlines (rows, stride) uint8."""
    raw = raw.reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(rows):
        kind, x = int(raw[r, 0]), raw[r, 1:]
        if kind == 0:
            cur = x.copy()
        elif kind == 1:      # Sub: a running sum per byte of the pixel
            cur = np.cumsum(x.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = x + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            xs, up = x.tolist(), prev.tolist()
            cur_l = [0] * stride
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pred = _paeth(a, up[i], c)
                cur_l[i] = (xs[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[r] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, 3) array: uint8, or uint16 for
    16-bit gray."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    idat, header = [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    ch = _CHANNELS.get(color)
    if ch is None or depth not in (8, 16) or (depth == 16 and ch != 1) \
            or interlace:
        raise ValueError(
            f"PNG: unsupported format (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); 8-bit gray/RGB and 16-bit "
            "gray are read")
    nbytes = depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * ch * nbytes, ch * nbytes)
    if nbytes == 2:
        return px.view(">u2").astype(np.uint16).reshape(h, w)
    return px.reshape((h, w, ch) if ch > 1 else (h, w))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) uint8/uint16 gray or (H, W, 3) uint8 RGB -> PNG bytes."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        color, depth = 0, 8 * img.dtype.itemsize
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color, depth = 2, 8
    else:
        raise ValueError(f"PNG: cannot write {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    px = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                              if depth == 16 else img)
    rows = px.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
