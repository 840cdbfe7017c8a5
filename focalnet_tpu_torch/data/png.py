"""PNG codec in numpy and the standard library's ``zlib``.

The plain version of the native loader's PNG path
(:mod:`focalnet_tpu_torch.data.native_loader`): the tests and the card's
smoke run hold the C++ codec against it, and ``TrainLoader(backend="numpy")``
reads through it.

- :func:`decode_png`: every colour type and bit depth, the five scanline
  filters, Adam7, CRC-checked.  Returns (H, W, channels) uint8: 16-bit
  samples give their high byte and gray below 8 bits is scaled to 8, as
  libpng's ``png_set_strip_16`` and ``png_set_expand_gray_1_2_4_to_8`` do;
  a palette image gives its RGB, or RGBA where it has a tRNS chunk.
- :func:`to_rgb`: what the loader keeps of it, (H, W, 3).
- :func:`encode_png`: 8-bit gray, RGB or RGBA; rows filtered with the
  filter types given, in turn (0, None, by default).
- :func:`read_png_size`: (H, W) from the header alone.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    """(kind, body) of each chunk up to IEND.  A bad CRC fails a critical
    chunk and drops an ancillary one, as libpng does."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        pos += 12 + length
        if len(crc) != 4:
            break
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            if not kind[0] & 0x20:
                raise ValueError(f"corrupt PNG chunk {kind!r}")
            continue
        yield kind, body
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


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """The first ``n`` samples of each unfiltered row, at 8 bits or fewer
    (16-bit: the high byte)."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        return rows[:, 0 : 2 * n : 2]
    bits = np.unpackbits(rows, axis=1)[:, : n * depth].reshape(len(rows), n, depth)
    return (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(
        axis=2).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 gray, 2 gray+alpha, 3 RGB (or a
    palette), 4 RGBA (or a palette with tRNS)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif header is None:
            raise ValueError("PNG without IHDR first")
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if (depth not in _DEPTHS.get(ctype, ()) or comp or filt or interlace > 1 or not w or not h
            or (ctype == 3 and palette is None)):
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    passes = [(0, 0, 1, 1)] if interlace == 0 else _ADAM7
    shapes = [(-(-(h - y0) // dy) if h > y0 else 0, -(-(w - x0) // dx) if w > x0 else 0)
              for x0, y0, dx, dy in passes]
    strides = [(pw * ch * depth + 7) // 8 for _, pw in shapes]
    size = sum(ph * (s + 1) for (ph, pw), s in zip(shapes, strides) if ph and pw)
    # all the image's bytes; a stream with more, or without its end, is read
    try:
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), size), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if raw.size < size:
        raise ValueError("PNG image data is too short")
    out = np.zeros((h, w, ch), np.uint8)
    bpp = max(1, ch * depth // 8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw), stride in zip(passes, shapes, strides):
        if not (ph and pw):  # an empty pass has no bytes at all
            continue
        rows = _unfilter(raw[pos : pos + ph * (stride + 1)], ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _samples(rows, pw * ch, depth).reshape(ph, pw, ch)
    if ctype == 3:  # an index beyond the palette reads black, opaque
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[: len(palette), :3] = palette
        if trns is not None:
            lut[: len(trns), 3] = trns
        return lut[out[..., 0], : 4 if trns is not None else 3]
    if ctype == 0 and depth < 8:
        out *= 255 // ((1 << depth) - 1)  # 1-, 2-, 4-bit: v * 255, 85, 17
    return out


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W, 3) RGB: gray replicated, alpha dropped, as PIL's
    ``convert("RGB")`` and the native loader do."""
    if img.shape[2] <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _filter_rows(img: np.ndarray, filters) -> np.ndarray:
    """(h, w, bpp) bytes, ``bpp`` a pixel -> (h, 1 + w bpp) filtered rows,
    row y with filter ``filters[y % len(filters)]`` in front.  Every
    predictor reads the unfiltered image, so all five come out of
    whole-array operations."""
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kinds = np.resize(np.asarray(filters, np.int64), h)
    if ((kinds < 0) | (kinds > 4)).any():
        raise ValueError(f"PNG filter types are 0-4, got {filters}")
    rows = ((x - preds[kinds, np.arange(h)]) % 256).astype(np.uint8)
    return np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(img: np.ndarray, level: int = 1, filters=(0,)) -> bytes:
    """(H, W) or (H, W, C) uint8 with C in {1, 3, 4} -> PNG bytes, row y
    filtered with ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth).  PNG is lossless at every zlib level; level 1
    favours speed."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if img.dtype != np.uint8 or ctype is None:
        raise ValueError(f"expected (H, W, 1|3|4) uint8, got {img.shape} {img.dtype}")
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(_filter_rows(img, filters).tobytes(), level))
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


def write_png(path: str, img: np.ndarray, level: int = 1, filters=(0,)) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level, filters))
