"""The port's serving path on the CPU, against the JAX package's ``serve``.

A tiny ``1mlp_g2`` (``vssg_dim=16``, ``ssm_d_state=4``) gets seeded weights
from the port's init laws; the JAX model gets the same weights through the
JAX converter.  Both servers answer the same PNG requests; their PNGs must
agree within 1 LSB (the forwards agree to ~1e-6, so only values within that
of a quantisation step can round apart).  Also: ``--tile`` mode through the
CLI, and the port's PNG codec against PIL.
"""

import io
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from focalnet_tpu.evaluation.serve import serve as jax_serve
from focalnet_tpu.models import build_net as jax_build_net
from focalnet_tpu.utils.convert import convert_state_dict
from focalnet_tpu_torch.data.png import decode_png, encode_png, read_png, write_png
from focalnet_tpu_torch.data.reside import _load_image_u8
from focalnet_tpu_torch.evaluation import serve
from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.utils import save_checkpoint

torch.set_num_threads(1)

TINY = dict(vssg_dim=16, ssm_d_state=4)


def _tiny_port():
    return build_net("1mlp_g2", device="cpu",
                     generator=torch.Generator().manual_seed(1234), **TINY)


def _requests(tmp_path, sizes, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for h, w in sizes:
        path = str(tmp_path / f"req_{h}x{w}.png")
        write_png(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(path)
    return paths


def _run(server, paths, out_dir, **kw):
    out = io.StringIO()
    req = "".join(f"{p}\t{os.path.join(out_dir, os.path.basename(p))}\n" for p in paths)
    server(result_dir=out_dir, inp=io.StringIO(req), out=out, **kw)
    lines = out.getvalue().splitlines()
    assert lines[0] == "READY"
    assert [ln.split("\t")[0] for ln in lines[1:]] == ["OK"] * len(paths), lines
    return [read_png(ln.split("\t")[1]) for ln in lines[1:]]


def test_serve_matches_jax(tmp_path):
    port = _tiny_port()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jmodel = jax_build_net("1mlp_g2", scan_backend="chunked", **TINY)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            np.zeros((1, 32, 32, 3), np.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, report = convert_state_dict(sd, template)
    assert not report["missing"] and not report["unused"]

    # 40x24 is reflect-padded to 64x32 and cropped back
    paths = _requests(tmp_path, [(32, 32), (40, 24)])
    got = _run(lambda **kw: serve(port, device="cpu", **kw), paths,
               str(tmp_path / "port"))
    want = _run(lambda **kw: jax_serve(jmodel, params, **kw), paths,
                str(tmp_path / "jax"))
    for g, w, (h, wd) in zip(got, want, [(32, 32), (40, 24)]):
        assert g.shape == w.shape == (h, wd, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_cli_serves_tiles(tmp_path):
    """``python -m focalnet_tpu_torch.main --mode serve --tile 32`` on a
    48x64 request: 4 overlapping tiles blended back to 48x64."""
    ckpt = str(tmp_path / "tiny.pkl")
    save_checkpoint(ckpt, _tiny_port().state_dict())
    (path,) = _requests(tmp_path, [(48, 64)], seed=1)
    argv = ["--mode", "serve", "--test_model", ckpt, "--device", "cpu",
            "--vssg_dim", "16", "--ssm_d_state", "4", "--tile", "32",
            "--tile_overlap", "8", "--model_save_dir", str(tmp_path / "w")]
    (img,) = _run(lambda **kw: main(argv + ["--result_dir", kw["result_dir"]],
                                    inp=kw["inp"], out=kw["out"]),
                  [path], str(tmp_path / "tiled"))
    assert img.shape == (48, 64, 3)


# ------------------------------------------------------------------ PNG codec

def _png(body_rows: bytes, w, h, ctype):
    chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body_rows)) + chunk(b"IEND", b""))


def _every_filter_png(img):
    """PNG bytes whose rows cycle through filter types 0-4 (None, Sub, Up,
    Average, Paeth), filtered here independently of the codec under test."""
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int64)
    shift = lambda r: np.concatenate([np.zeros(ch, np.int64), r[:-ch]])
    rows = []
    for y in range(h):
        x, up = raw[y], raw[y - 1] if y else np.zeros(w * ch, np.int64)
        left, ul = shift(x), shift(up)
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][y % 5]
        rows.append(np.concatenate([[y % 5], (x - pred) % 256]).astype(np.uint8))
    return _png(np.concatenate(rows).tobytes(), w, h, {1: 0, 3: 2, 4: 6}[ch])


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_codec(tmp_path, ch):
    img = np.random.default_rng(ch).integers(0, 256, (23, 17, ch), dtype=np.uint8)
    # round trip
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    # every filter type, against PIL on the same bytes
    data = _every_filter_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    # a file PIL wrote (its own adaptive filter choice per row)
    path = str(tmp_path / "pil.png")
    Image.fromarray(img[..., 0] if ch == 1 else img).save(path)
    np.testing.assert_array_equal(read_png(path), img)
    # the serving loader converts to RGB as PIL's convert("RGB") does
    with Image.open(path) as im:
        np.testing.assert_array_equal(_load_image_u8(path),
                                      np.asarray(im.convert("RGB")))
