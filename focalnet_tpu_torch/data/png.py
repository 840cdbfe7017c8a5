"""PNG codec in numpy and the standard library's ``zlib``.

The serving path reads its requests and writes its answers as PNG.  The JAX
package does that with a C++ libpng loader or PIL; the port's machines need
neither.

- :func:`decode_png`: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced,
  all five scanline filters, CRC-checked.  Returns (H, W, channels) uint8.
- :func:`encode_png`: 8-bit gray, RGB or RGBA; every row with filter 0.
- :func:`read_png_size`: (H, W) from the header alone.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + stride) bytes -> (h, stride)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per sample, modulo 256
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256)
            cur = cur.astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev  # uint8 wraps modulo 256
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (8-bit gray/gray+alpha/RGB/RGBA, "
            "non-interlaced only)")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError("PNG image data has the wrong size")
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) or (H, W, C) uint8 with C in {1, 3, 4} -> PNG bytes.  PNG is
    lossless at every zlib level; level 1 favours speed."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if img.dtype != np.uint8 or ctype is None:
        raise ValueError(f"expected (H, W, 1|3|4) uint8, got {img.shape} {img.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def read_png_size(path: str):
    """(H, W) of a PNG file from its IHDR chunk, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))
