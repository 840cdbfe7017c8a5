"""ctypes binding of the port's native C++ data loader (``data/csrc/loader.cpp``).

The counterpart of ``focalnet_tpu/data/native_loader.py``: decode PNG and
JPEG, encode PNG, and assemble training batches of paired random crops and
flips in C++ threads, with the JAX binding's functions, arguments, returns
and ``IOError`` on a failed call.  The library is built with g++ at first
use (:func:`get_lib`) into ``focalnet_tpu_torch/_build/``, never when this
module is imported.  It links zlib, and libpng and libjpeg where the host
has them (:func:`link_flags` probes each); without libpng the source's own
PNG codec over zlib takes their place, with the same pixels.  A library
that does not build raises with the compiler's output: nothing falls back.

The plain versions, for tests and the card's smoke run: the numpy codec of
:mod:`focalnet_tpu_torch.data.png` and :func:`load_pair_batch_ref`.

``decode_image.images`` and ``decode_image_u8.images`` count the images
decoded one by one, ``load_pair_batch.batches`` the batches assembled.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import List

import numpy as np

from focalnet_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "loader.cpp")
_JPEG_MAGIC = b"\xff\xd8"
_COUNT_LOCK = threading.Lock()

# a library is linked when this program compiles and links against it
_PROBES = {
    "libpng": ("#include <png.h>\nint main() { return png_access_version_number() == 0; }\n",
               "-lpng", "-DFNL_NO_LIBPNG"),
    "libjpeg": ("#include <cstdio>\n#include <jpeglib.h>\n"
                "int main() { return jpeg_std_error(nullptr) != nullptr; }\n", "-ljpeg",
                "-DFNL_NO_LIBJPEG"),
}


def _links(name: str) -> bool:
    program, lib, _ = _PROBES[name]
    proc = subprocess.run([_build.find_cxx(), "-x", "c++", "-", "-o", os.devnull, lib],
                          input=program, capture_output=True, text=True)
    return proc.returncode == 0


def link_flags(libpng: bool | None = None, libjpeg: bool | None = None) -> List[str]:
    """The g++ flags after the source: zlib always; libpng and libjpeg where
    they link (``None``: probe the host), else the define that builds
    without them (``False`` forces that, as the card's host needs: it has
    neither)."""
    flags = []
    for name, want in (("libpng", libpng), ("libjpeg", libjpeg)):
        _, lib, without = _PROBES[name]
        flags.append(lib if (_links(name) if want is None else want) else without)
    return flags + ["-lz"]


def build_library(libpng: bool | None = None, libjpeg: bool | None = None) -> ctypes.CDLL:
    """Build (unless built) and bind the loader with :func:`link_flags`."""
    lib = _build.load_host_library(SOURCE, link_flags(libpng, libjpeg))
    lib.fnl_build_info.restype = ctypes.c_char_p
    lib.fnl_build_info.argtypes = []
    lib.fnl_has_jpeg.restype = ctypes.c_int
    lib.fnl_has_jpeg.argtypes = []
    for fn, elem in ((lib.fnl_decode_image, ctypes.c_float),
                     (lib.fnl_decode_image_u8, ctypes.c_uint8)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(elem), ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fnl_load_pair_batch.restype = ctypes.c_int
    lib.fnl_load_pair_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.fnl_encode_png.restype = ctypes.c_int
    lib.fnl_encode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loader built for this host (at first call), or raises."""
    return build_library()


def build_info(lib=None) -> str:
    """Which codecs the build has, e.g. ``png: own codec over zlib; jpeg:
    none; zlib 1.3``."""
    return (lib or get_lib()).fnl_build_info().decode()


def has_jpeg(lib=None) -> bool:
    return bool((lib or get_lib()).fnl_has_jpeg())


def _count(fn, **counts) -> None:
    with _COUNT_LOCK:  # the prefetch thread and the caller's both decode
        for k, n in counts.items():
            setattr(fn, k, getattr(fn, k) + n)


def _failed(what: str, rc: int, path: str, lib) -> IOError:
    msg = f"native {what} failed ({rc}): {path}"
    if not lib.fnl_has_jpeg():
        with open(path, "rb") as f:
            if f.read(2) == _JPEG_MAGIC:
                msg += " (a JPEG, and this build has no libjpeg: " + build_info(lib) + ")"
    return IOError(msg)


def _decode(fn, dtype, ctype, what, path, max_h, max_w, lib):
    buf = np.empty((max_h, max_w, 3), dtype)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = fn(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctype)), max_h, max_w,
            ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise _failed(what, rc, path, lib)
    return buf.reshape(-1)[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_image(path: str, max_h: int = 4096, max_w: int = 4096, lib=None) -> np.ndarray:
    """Decode one image to float32 RGB (H, W, 3) in [0, 1], ``u8 / 255.0``
    bit for bit.  An image larger than (max_h, max_w) raises (code -2)."""
    lib = lib or get_lib()
    out = _decode(lib.fnl_decode_image, np.float32, ctypes.c_float, "decode", path,
                  max_h, max_w, lib)
    _count(decode_image, images=1)
    return out


def decode_image_u8(path: str, max_h: int = 4096, max_w: int = 4096, lib=None) -> np.ndarray:
    """Decode one image to uint8 RGB (H, W, 3): the serving upload format."""
    lib = lib or get_lib()
    out = _decode(lib.fnl_decode_image_u8, np.uint8, ctypes.c_uint8, "u8 decode", path,
                  max_h, max_w, lib)
    _count(decode_image_u8, images=1)
    return out


def load_pair_batch(hazy_paths: List[str], gt_paths: List[str], crop: int,
                    seeds: np.ndarray, num_threads: int = 4, lib=None):
    """Decode and paired-augment a batch in ``num_threads`` C++ threads:
    (hazy, gt) float32 (n, crop, crop, 3).  Example i is cropped at the
    SplitMix64 stream of ``seeds[i]`` (see :func:`load_pair_batch_ref`).
    Raises ``IOError`` with the first failing example's code: -1 / -2 the
    hazy / GT image did not decode, -3 their sizes differ, -4 the image is
    smaller than the crop (no padding)."""
    lib = lib or get_lib()
    n = len(hazy_paths)
    if len(gt_paths) != n or len(seeds) != n:
        raise ValueError(f"{n} hazy paths, {len(gt_paths)} GT paths, {len(seeds)} seeds")
    hz = (ctypes.c_char_p * n)(*[p.encode() for p in hazy_paths])
    gt = (ctypes.c_char_p * n)(*[p.encode() for p in gt_paths])
    seeds = np.ascontiguousarray(seeds, np.uint64)
    out_h = np.empty((n, crop, crop, 3), np.float32)
    out_g = np.empty((n, crop, crop, 3), np.float32)
    rc = lib.fnl_load_pair_batch(
        hz, gt, n, crop,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    if rc != 0:
        raise IOError(f"native batch load failed ({rc}) on {n} pairs from {hazy_paths[0]}")
    _count(load_pair_batch, batches=1)
    return out_h, out_g


def encode_png(path: str, rgb_u8: np.ndarray, level: int = 1, lib=None) -> None:
    """Write uint8 RGB (H, W, 3) as PNG (every row with the Sub filter, zlib
    ``level``; lossless at every level).  Raises ``IOError`` on failure."""
    lib = lib or get_lib()
    arr = np.ascontiguousarray(rgb_u8, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {arr.shape}")
    rc = lib.fnl_encode_png(path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            arr.shape[0], arr.shape[1], level)
    if rc != 0:
        raise IOError(f"native PNG encode failed ({rc}): {path}")


decode_image.images = 0
decode_image_u8.images = 0
load_pair_batch.batches = 0


# ---------------------------------------------------------------- plain version

_MASK64 = (1 << 64) - 1


def _splitmix64(state: int):
    """SplitMix64's state after one step and its output, in Python integers."""
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


def crop_draws(seed: int, h: int, w: int, crop: int):
    """(i0, j0, flip) of an example with ``seed`` from an (h, w) image: two
    Lemire bounded draws, then one uniform below 0.5, as the C++ draws them."""
    state, draws = int(seed) & _MASK64, []
    for bound in (h - crop + 1, w - crop + 1):
        state, z = _splitmix64(state)
        draws.append((z * bound) >> 64)
    state, z = _splitmix64(state)
    return draws[0], draws[1], (z >> 11) * (1.0 / 9007199254740992.0) < 0.5


def load_pair_batch_ref(hazy_paths: List[str], gt_paths: List[str], crop: int,
                        seeds: np.ndarray):
    """The plain version of :func:`load_pair_batch`: the numpy codec, the
    draws of :func:`crop_draws`, a numpy crop and flip, then ``/ 255.0``;
    the same codes in its ``IOError``."""
    from focalnet_tpu_torch.data.png import read_png, to_rgb

    hazy, gt = [], []
    for hp, gp, seed in zip(hazy_paths, gt_paths, seeds):
        pair = []
        for code, path in ((-1, hp), (-2, gp)):
            try:
                pair.append(to_rgb(read_png(path)))
            except (OSError, ValueError) as e:
                raise IOError(f"plain batch load failed ({code}): {path}: {e}") from e
        a, b = pair
        if a.shape != b.shape:
            raise IOError(f"plain batch load failed (-3): {hp} {a.shape}, {gp} {b.shape}")
        h, w = a.shape[:2]
        if h < crop or w < crop:
            raise IOError(f"plain batch load failed (-4): {hp} is {h}x{w}, the crop {crop}")
        i0, j0, flip = crop_draws(seed, h, w, crop)
        for img, out in ((a, hazy), (b, gt)):
            img = img[i0 : i0 + crop, j0 : j0 + crop]
            out.append((img[:, ::-1] if flip else img).astype(np.float32) / 255.0)
    empty = np.zeros((0, crop, crop, 3), np.float32)
    return (np.stack(hazy) if hazy else empty), (np.stack(gt) if gt else empty)
