"""The port's native C++ loader against the JAX package's and its own plain
versions.

- Every PNG variant that libpng normalises (palette, with tRNS, 1/2/4-bit
  gray and palette indices, 16-bit gray and RGB, gray+alpha, RGBA, Adam7,
  rows with every filter) decodes alike through the port's native library
  (its build for this host and its build without libpng or libjpeg, the
  card host's), the port's numpy codec and JAX's native decode or, without
  that, PIL; 16-bit files only against JAX's native decode (PIL's
  ``convert("RGB")`` need not keep libpng's high byte).
- JPEG: the port's native decode against JAX's, which links the same
  libjpeg; the build without libjpeg names the missing library.
- ``load_pair_batch`` bit for bit against JAX's native one and against
  ``load_pair_batch_ref``; the error codes; ``TrainLoader(backend="native")``
  against JAX's for two epochs; ``rows``; ``save_image``; a failed build.

No JAX model is built.  The two port builds and JAX's ``make`` run at once in
a module fixture (about 3 s on a cold checkout).
"""

import importlib.util
import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from focalnet_tpu.data import native_loader as jax_native
from focalnet_tpu.data.reside import TrainLoader as JaxTrainLoader
from focalnet_tpu.data.reside import make_synthetic_dataset as jax_make_dataset
from focalnet_tpu_torch.data import native_loader
from focalnet_tpu_torch.data.native_loader import (
    build_library,
    decode_image,
    decode_image_u8,
    encode_png,
    load_pair_batch,
    load_pair_batch_ref,
)
from focalnet_tpu_torch.data.png import _filter_rows, decode_png, read_png, to_rgb
from focalnet_tpu_torch.data.reside import (
    SYNTHETIC_FILTERS,
    TrainLoader,
    _load_image,
    _load_image_u8,
    make_synthetic_dataset,
)
from focalnet_tpu_torch.evaluation.metrics import save_image
from focalnet_tpu_torch.ops import _build

SIG = b"\x89PNG\r\n\x1a\n"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_metrics():
    """The JAX package's ``evaluation/metrics.py`` alone: its package's
    ``__init__`` imports the models and jax's compiler, which ``save_image``
    does not need."""
    spec = importlib.util.spec_from_file_location(
        "jax_metrics_alone", os.path.join(_ROOT, "focalnet_tpu", "evaluation", "metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def libs():
    """{"host": this host's build, "zlib": the build without libpng and
    libjpeg}, and whether JAX's native library built."""
    with ThreadPoolExecutor(3) as ex:
        host = ex.submit(native_loader.get_lib)
        own = ex.submit(build_library, False, False)
        jax_ok = ex.submit(jax_native.native_available)
        return {"host": host.result(), "zlib": own.result()}, jax_ok.result()


# ---------------------------------------------------------------- PNG writers


def _png(w, h, depth, ctype, raw, interlace=0, chunks=()):
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = [(b"IHDR", ihdr), *chunks, (b"IDAT", zlib.compress(raw)), (b"IEND", b"")]
    return SIG + b"".join(struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
                          for k, b in body)


def _rows(samples, depth, filters):
    """(h, w, ch) samples -> the filtered rows' bytes at ``depth``."""
    h, w, ch = samples.shape
    if depth == 16:
        img = samples.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch)
    elif depth == 8:
        img = samples.astype(np.uint8)
    else:  # packed, most significant bits first; filters see bytes
        bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
        img = np.packbits(bits.reshape(h, -1), axis=1)[..., None]
    return _filter_rows(img, filters).tobytes()


def _written(samples, depth, ctype, filters=SYNTHETIC_FILTERS, interlace=0, chunks=()):
    h, w = samples.shape[:2]
    if not interlace:
        return _png(w, h, depth, ctype, _rows(samples, depth, filters), chunks=chunks)
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _rows(sub, depth, filters)
    return _png(w, h, depth, ctype, raw, interlace=1, chunks=chunks)


def _pil(img, mode=None, **save):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "PNG", **save)
    return buf.getvalue()


def _palette_image(rng, hw, colors, **save):
    rgb = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    return _pil_p(Image.fromarray(rgb).quantize(colors), **save)


def _pil_p(im, **save):
    buf = io.BytesIO()
    im.save(buf, "PNG", **save)
    return buf.getvalue()


def _variants():
    rng = np.random.default_rng(13)
    rgb = rng.integers(0, 256, (23, 29, 3), dtype=np.uint8)
    plte = rng.integers(0, 256, (4, 3), dtype=np.uint8).tobytes()
    idx2 = rng.integers(0, 4, (19, 21, 1))
    return {
        "rgb8_every_filter": _written(rgb, 8, 2),
        "palette8": _palette_image(rng, (23, 29), 200),
        "palette4_trns": _palette_image(rng, (23, 29), 12, transparency=3),
        "palette2_adam7_trns": _written(idx2, 2, 3, interlace=1,
                                        chunks=[(b"PLTE", plte), (b"tRNS", b"\x00\x80")]),
        "gray1": _pil(rng.integers(0, 2, (17, 27), dtype=np.uint8).astype(bool)),
        "gray2": _written(rng.integers(0, 4, (17, 27, 1)), 2, 0),
        "gray4_trns": _written(rng.integers(0, 16, (17, 27, 1)), 4, 0,
                               chunks=[(b"tRNS", b"\x00\x05")]),
        "gray16": _written(rng.integers(0, 65536, (21, 19, 1)), 16, 0),
        "rgb16": _written(rng.integers(0, 65536, (21, 19, 3)), 16, 2),
        "gray_alpha": _pil(rng.integers(0, 256, (23, 29, 2), dtype=np.uint8), "LA"),
        "rgba": _pil(rng.integers(0, 256, (23, 29, 4), dtype=np.uint8), "RGBA"),
        "rgba16_adam7": _written(rng.integers(0, 65536, (13, 11, 4)), 16, 6, interlace=1),
        "rgb8_adam7": _written(rgb, 8, 2, interlace=1),
        "rgb8_adam7_tiny": _written(rgb[:3, :5], 8, 2, interlace=1),
    }


VARIANTS = _variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_png_variants_decode_alike(libs, tmp_path, name):
    """Three decoders agree bit for bit on each variant; float = u8 / 255."""
    built, jax_ok = libs
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(VARIANTS[name])
    want = to_rgb(decode_png(VARIANTS[name]))  # the numpy codec
    assert want.shape[2] == 3 and want.dtype == np.uint8
    if jax_ok:
        np.testing.assert_array_equal(jax_native.decode_image_u8(path), want)
    if "16" not in name:
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)
    for lib in built.values():
        np.testing.assert_array_equal(decode_image_u8(path, lib=lib), want)
        np.testing.assert_array_equal(decode_image(path, lib=lib),
                                      want.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(_load_image_u8(path), want)
    np.testing.assert_array_equal(_load_image(path), want.astype(np.float32) / 255.0)


def test_jpeg_decodes_as_jax(libs, tmp_path, monkeypatch):
    """Where the build links libjpeg, a JPEG decodes as JAX's native decode
    does; the build without it names the library, and ``_load_image`` then
    reads JPEG through PIL (and still PNG natively)."""
    built, jax_ok = libs
    path = str(tmp_path / "a.jpg")
    rgb = np.random.default_rng(2).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(path, quality=90)
    with pytest.raises(IOError, match="no libjpeg"):
        decode_image(path, lib=built["zlib"])
    png = str(tmp_path / "b.png")
    Image.fromarray(rgb).save(png)
    monkeypatch.setattr(native_loader, "get_lib", lambda: built["zlib"])
    with Image.open(path) as im:
        np.testing.assert_array_equal(_load_image_u8(path), np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(_load_image_u8(png), rgb)
    monkeypatch.undo()
    if not native_loader.has_jpeg():
        pytest.skip(f"this host's build has no libjpeg ({native_loader.build_info()})")
    if not jax_ok:
        pytest.skip("the JAX package's native loader did not build here")
    np.testing.assert_array_equal(decode_image_u8(path), jax_native.decode_image_u8(path))
    np.testing.assert_array_equal(decode_image(path), jax_native.decode_image(path))
    np.testing.assert_array_equal(_load_image(path), jax_native.decode_image(path))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reside"))
    make_synthetic_dataset(root, n_train=3, n_test=1, hw=(40, 48))
    d = os.path.join(root, "train")
    names = sorted(os.listdir(os.path.join(d, "hazy")))
    return (root, [os.path.join(d, "hazy", n) for n in names],
            [os.path.join(d, "gt", n.split("_")[0] + ".png") for n in names])


def test_synthetic_rows_take_every_filter(split):
    root, hazy, gt = split
    for path in hazy + gt:
        with open(path, "rb") as f:
            data = f.read()
        w, h = struct.unpack(">II", data[16:24])
        idat = b"".join(body for kind, body in _chunk_list(data) if kind == b"IDAT")
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
        assert set(raw[:, 0].tolist()) == {0, 1, 2, 3, 4}, path


def _chunk_list(data):
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        yield data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n


@pytest.mark.parametrize("threads", [1, 3])
def test_pair_batch_matches_jax_and_plain(libs, split, threads):
    built, jax_ok = libs
    _, hazy, gt = split
    seeds = np.asarray([7, 2**31 - 1, 0, 123456789, 2**63 + 5, 42], np.uint64)
    want = load_pair_batch_ref(hazy, gt, 32, seeds)
    assert want[0].shape == (6, 32, 32, 3)
    # the seeds take both flips and several crops
    draws = {native_loader.crop_draws(s, 40, 48, 32) for s in seeds}
    assert {d[2] for d in draws} == {True, False} and len(draws) > 3
    if jax_ok:
        for a, b in zip(jax_native.load_pair_batch(hazy, gt, 32, seeds, threads), want):
            np.testing.assert_array_equal(a, b)
    for lib in built.values():
        for a, b in zip(load_pair_batch(hazy, gt, 32, seeds, threads, lib=lib), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("code", [-1, -2, -3, -4])
def test_pair_batch_error_codes(libs, split, tmp_path, code):
    built, _ = libs
    _, hazy, gt = split
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(SIG + b"not a PNG body")
    small = str(tmp_path / "small.png")
    Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(small)
    h, g, crop = list(hazy[:2]), list(gt[:2]), 32
    if code == -1:
        h[1] = bad
    elif code == -2:
        g[1] = bad
    elif code == -3:
        g[1] = small
    else:
        crop = 41
    seeds = np.arange(2, dtype=np.uint64)
    for lib in built.values():
        with pytest.raises(IOError, match=rf"\({code}\)"):
            load_pair_batch(h, g, crop, seeds, lib=lib)
    with pytest.raises(IOError, match=rf"\({code}\)"):
        load_pair_batch_ref(h, g, crop, seeds)
    if code == -1:
        for lib in built.values():
            with pytest.raises(IOError, match=r"\(-1\)"):
                decode_image(bad, lib=lib)


def test_train_loader_native_matches_jax(libs, tmp_path):
    """Two epochs of batches, bit for bit, at the same seed; a backend other
    than "native" or "numpy" is refused."""
    _, jax_ok = libs
    if not jax_ok:
        pytest.skip("the JAX package's native loader did not build here")
    jax_make_dataset(str(tmp_path / "jax"), n_train=3, n_test=1, hw=(40, 48))
    make_synthetic_dataset(str(tmp_path / "port"), n_train=3, n_test=1, hw=(40, 48))
    jl = JaxTrainLoader(str(tmp_path / "jax"), 2, num_workers=2, crop=32, seed=5,
                        backend="native")
    pl = TrainLoader(str(tmp_path / "port"), 2, num_workers=2, crop=32, seed=5)
    assert pl.backend == "native" and len(pl) == len(jl) == 3
    for _ in range(2):
        got, want = list(pl.epoch()), list(jl.epoch())
        assert len(got) == len(want) == 3
        for (gh, gg), (wh, wg) in zip(got, want):
            assert gh.shape == (2, 32, 32, 3) and gh.dtype == np.float32
            np.testing.assert_array_equal(gh, wh)
            np.testing.assert_array_equal(gg, wg)
    with pytest.raises(ValueError, match="backend"):
        TrainLoader(str(tmp_path / "port"), 2, backend="auto")


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_train_loader_rows(split, backend):
    """A rank's rows are those rows of the whole batch; no rows, empty arrays."""
    root = split[0]
    whole = list(TrainLoader(root, 4, num_workers=2, crop=32, seed=3, backend=backend).epoch())
    part = list(TrainLoader(root, 4, num_workers=2, crop=32, seed=3, rows=[1, 3],
                            backend=backend).epoch())
    none = list(TrainLoader(root, 4, num_workers=2, crop=32, seed=3, rows=[],
                            backend=backend).epoch())
    assert len(whole) == len(part) == len(none) == 1
    for k in range(2):
        np.testing.assert_array_equal(part[0][k], whole[0][k][[1, 3]])
        assert none[0][k].shape == (0, 32, 32, 3)


def test_save_image_matches_jax(libs, tmp_path):
    """The same pixels as JAX's ``save_image``; each build's encoder writes
    rows with the Sub filter, decoded alike by the numpy codec and PIL."""
    built, jax_ok = libs
    pred = np.random.default_rng(4).uniform(-0.1, 1.1, (21, 34, 3)).astype(np.float32)
    port, jax = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    save_image(pred, port)
    _jax_metrics().save_image(pred, jax)
    want = np.asarray(Image.open(jax))
    np.testing.assert_array_equal(read_png(port), want)
    for name, lib in built.items():
        path = str(tmp_path / f"{name}.png")
        encode_png(path, want, lib=lib)
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(decode_png(data), want)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
        if name == "zlib":  # the own codec's rows, all Sub
            idat = b"".join(b for k, b in _chunk_list(data) if k == b"IDAT")
            raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(21, 1 + 34 * 3)
            assert set(raw[:, 0].tolist()) == {1}


@pytest.mark.parametrize("cxx", ["missing", "fails"])
def test_failed_build_raises(tmp_path, monkeypatch, cxx):
    """A compiler that is not there, or that fails, raises with its output:
    the binding returns no library and decodes nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++") if cxx == "missing" else "false")
    with pytest.raises(RuntimeError, match="not found" if cxx == "missing" else r"false failed \(1\)"):
        build_library()
    assert not os.path.exists(tmp_path / "build") or not any(
        f.endswith(".so") for f in os.listdir(tmp_path / "build"))
