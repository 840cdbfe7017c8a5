"""Inference on images without ground truth (counterpart of
``focalnet_tpu/evaluation/infer.py``).

``infer()`` is ``--mode infer``: it dehazes an image or a directory of
images into ``result_dir``, whole images (reflect-padded to a multiple of
``factor``, cropped back, clamped, saved with the +0.5/255 offset) or
``tile`` crops.  One thread decodes the next item and one encodes earlier
answers while the card computes; under a process mesh every rank runs it
and forwards its rows of each batch (JAX's batches sharded over ``data``).
:func:`tiled_forward` is also serve's ``--tile`` mode: overlapping (tile,
tile) crops, feather-blended back together, so device memory is bounded by
the tile.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from focalnet_tpu_torch.data.png import read_png_size
from focalnet_tpu_torch.data.reside import _load_image_u8, pil_image
from focalnet_tpu_torch.evaluation.metrics import pad_to_multiple, save_image
from focalnet_tpu_torch.parallel.mesh import all_gather, local_rows
from focalnet_tpu_torch.utils.device import resolve_device
from focalnet_tpu_torch.utils.meters import Adder

_EXTS = (".png", ".jpg", ".jpeg")


def _list_images(path: str) -> List[str]:
    """``path`` itself if it is a file, else its png/jpg/jpeg files, sorted."""
    if os.path.isfile(path):
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(_EXTS))


def _pipeline(items, decode_fn, run_fn, save_cap: int):
    """Run ``run_fn(decode_fn(item), saver)`` over ``items`` while one thread
    decodes the next item and one thread runs the writes that ``run_fn``
    hands to ``saver.submit``.  At most ``save_cap`` writes wait (each holds
    a full-size prediction), so an encode error surfaces near its cause;
    every write's error is raised."""
    save_futs = []

    class _Saver:
        def __init__(self, ex, max_pending):
            self.ex = ex
            self.max_pending = max(2, max_pending)

        def submit(self, *a):
            save_futs.append(self.ex.submit(*a))
            while len(save_futs) > self.max_pending:
                save_futs.pop(0).result()

    with ThreadPoolExecutor(1) as loader, ThreadPoolExecutor(1) as saver:
        sv = _Saver(saver, save_cap)
        pending = None
        for it in items:
            nxt = loader.submit(decode_fn, it)
            if pending is not None:
                run_fn(pending.result(), sv)
            pending = nxt
        if pending is not None:
            run_fn(pending.result(), sv)
    for f in save_futs:
        f.result()


def u8_forward(model, device: torch.device):
    """``fwd``: (B, H, W, 3) uint8 array -> the full-size output of ``model``
    on ``device``, a tensor there.  The upload is uint8 and x/255 runs on the
    device: a quarter of the float traffic."""

    def fwd(x_u8: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.from_numpy(x_u8).to(device).float() / 255.0
            return model(x)[2]

    return fwd


def _image_hw(path: str):
    """(H, W) from the image's header: a PNG's IHDR, other formats by PIL."""
    if path.lower().endswith(".png"):
        return read_png_size(path)
    with pil_image(path).open(path) as im:
        w, h = im.size
    return h, w


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile offsets covering ``[0, size)``; the last tile is flush to the end."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def _tile_weights(tile: int, overlap: int) -> np.ndarray:
    """(tile, tile, 1) blend weights: 1 inside, a linear ramp across the
    ``overlap`` margin on every side (normalised by the weight sum later)."""
    r = np.minimum(np.arange(1, tile + 1), np.arange(tile, 0, -1))
    w1 = np.minimum(r / float(overlap + 1), 1.0).astype(np.float32)
    return (w1[:, None] * w1[None, :])[..., None]


def _pad_to_min(img: np.ndarray, min_h: int, min_w: int) -> np.ndarray:
    """Reflect-pad (H, W, C) on the bottom/right up to at least (min_h, min_w),
    in steps (reflect adds at most size-1 per step; a size-1 dim replicates)."""
    while img.shape[0] < min_h or img.shape[1] < min_w:
        ph = min(min_h - img.shape[0], max(img.shape[0] - 1, 1)) if img.shape[0] < min_h else 0
        pw = min(min_w - img.shape[1], max(img.shape[1] - 1, 1)) if img.shape[1] < min_w else 0
        mode = "reflect" if min(img.shape[0], img.shape[1]) > 1 else "edge"
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode=mode)
    return img


def tiled_forward(fwd_batch, img: np.ndarray, tile: int, overlap: int,
                  batch_size: int = 1, inflight: int = 4) -> np.ndarray:
    """Dehaze ``img`` (H, W, C; H, W >= tile) as overlapping (tile, tile)
    crops through ``fwd_batch`` ((batch_size, tile, tile, C) array -> tensor
    of predictions), feather-blended.

    Up to ``inflight`` tile batches stay launched but not yet copied back
    (CUDA launches are asynchronous), so the card computes ahead while the
    host blends; blending stays in order, so the result does not depend on
    ``inflight``."""
    H, W, _ = img.shape
    stride = tile - overlap
    coords = [
        (y, x)
        for y in _tile_starts(H, tile, stride)
        for x in _tile_starts(W, tile, stride)
    ]
    wtile = _tile_weights(tile, overlap)
    out = np.zeros(img.shape, np.float32)
    wsum = np.zeros((H, W, 1), np.float32)
    pending: deque = deque()

    def blend(preds_dev, group):
        preds = preds_dev.float().cpu().numpy()[: len(group)]
        for pred, (y, x) in zip(preds, group):
            out[y : y + tile, x : x + tile] += pred * wtile
            wsum[y : y + tile, x : x + tile] += wtile

    for i in range(0, len(coords), batch_size):
        group = coords[i : i + batch_size]
        stack = np.stack([img[y : y + tile, x : x + tile] for y, x in group])
        if len(group) < batch_size:
            stack = np.concatenate(
                [stack, np.repeat(stack[-1:], batch_size - len(group), 0)]
            )
        pending.append((fwd_batch(stack), group))
        while len(pending) > max(inflight, 0):
            blend(*pending.popleft())
    while pending:
        blend(*pending.popleft())
    return out / wsum


def infer(model, input_path: str, result_dir: str, factor: int = 32,
          batch_size: int = 1, tile: int = 0, tile_overlap: int = 32,
          device=None, mesh=None) -> dict:
    """Dehaze every image under ``input_path`` (a file or a directory) into
    ``result_dir`` with ``model`` (a MIMOUNet) on ``device`` (default: the
    CUDA card; without one this raises).  Returns {"count", "avg_time"}.

    ``batch_size > 1`` groups the files by padded shape (from their headers)
    and runs up to ``batch_size`` of one shape per forward; a partial group
    runs at its own size.  ``factor`` (a multiple of 32) is the padding multiple: a
    coarser one makes fewer distinct shapes.  ``tile`` (a multiple of 32, 0
    = whole images) runs every image as overlapping (tile, tile) crops
    (:func:`tiled_forward`), ``batch_size`` of them per forward.

    An image's time runs from the upload to the prediction on the host (a
    batch's divided by its images), so it holds the forward on the card.

    ``mesh``: this rank's :class:`..parallel.Mesh` (every rank calls this).
    Each batch is sharded over its ``data`` axis, ``batch_size`` a multiple
    of that axis's size as in JAX: each rank forwards its rows
    (:func:`..parallel.mesh.local_rows`), and one with none (a partial
    bucket smaller than the axis) skips the forward; the ranks of a ``seq``
    row, whose model shards its scans over L, take the same rows and so
    forward or skip together.  Whole images: the ranks of ``seq`` index 0
    save their rows' images.  Tiles: the tile batches' predictions are
    all-gathered over ``data`` and rank 0 blends and saves."""
    device = resolve_device(device)
    n_data = mesh.shape.get("data", 1) if mesh is not None else 1
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} must be divisible by the mesh data-axis "
                         f"size {n_data} for sharded inference")
    model = model.to(device).eval()
    fwd = u8_forward(model, device)
    os.makedirs(result_dir, exist_ok=True)
    files = _list_images(input_path)
    if not files:
        raise FileNotFoundError(f"no images under {input_path!r}")
    time_adder = Adder()

    def save(pred, path, h, w):
        save_image(np.clip(pred[:h, :w], 0.0, 1.0),
                   os.path.join(result_dir, os.path.basename(path)))

    if tile:
        if tile % 32:
            raise ValueError(f"--tile must be a multiple of 32, got {tile}")
        if not 0 <= tile_overlap < tile:
            raise ValueError(f"--tile_overlap must be in [0, tile), got {tile_overlap}")
        bs = max(batch_size, 1)

        def decode_one(path):
            img = _load_image_u8(path)
            h, w = img.shape[:2]
            return path, _pad_to_min(img, tile, tile), h, w

        def fwd_tiles(stack):
            pred = fwd(stack[local_rows(len(stack), mesh)])
            if n_data == 1:
                return pred
            return all_gather(pred, mesh, "data").reshape(len(stack), *pred.shape[1:])

        def run_tiled(item, saver):
            path, img, h, w = item
            tm = time.time()
            pred = tiled_forward(fwd_tiles, img, tile, tile_overlap, bs)
            time_adder(time.time() - tm)
            if mesh is None or mesh.rank == 0:
                saver.submit(save, pred, path, h, w)

        _pipeline(files, decode_one, run_tiled, save_cap=4)
    else:
        if batch_size <= 1:
            path_batches = [[p] for p in files]
        else:
            by_shape: dict = {}
            for path in files:
                h, w = _image_hw(path)
                key = (-(-h // factor) * factor, -(-w // factor) * factor)
                by_shape.setdefault(key, []).append(path)
            path_batches = [group[i : i + batch_size] for group in by_shape.values()
                            for i in range(0, len(group), batch_size)]
        writes = mesh is None or mesh.axis_index("seq") == 0

        def decode(paths):
            batch = []
            for path in paths[local_rows(len(paths), mesh)]:
                padded, (h, w) = pad_to_multiple(_load_image_u8(path)[None], factor)
                batch.append((path, padded, h, w))
            return len(paths), batch

        def run(item, saver):
            n, batch = item
            if not batch:  # no rows of this batch on this rank
                return
            tm = time.time()
            preds = fwd(np.concatenate([b[1] for b in batch], axis=0)).cpu().numpy()
            time_adder((time.time() - tm) / n)
            for pred, (path, _, h, w) in zip(preds, batch):
                if writes:
                    saver.submit(save, pred, path, h, w)

        _pipeline(path_batches, decode, run, save_cap=2 * max(batch_size, 1))

    print("Dehazed %d images -> %s (avg %.3fs/img)" % (
        len(files), result_dir, time_adder.average()))
    return {"count": len(files), "avg_time": time_adder.average()}
