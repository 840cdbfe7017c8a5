"""RESIDE-ITS paired data pipeline (counterpart of ``focalnet_tpu/data/reside.py``).

Layout ``{root}/{split}/hazy/*.png`` with the GT of hazy ``8_1_0.9.png`` at
``{root}/{split}/gt/8.png`` (the name up to the first ``_``); png, jpg and
jpeg only.  Training takes a paired random crop and a paired horizontal flip;
validation loads pairs one by one at full size.  Images decode through the
port's native C++ loader (:mod:`.native_loader`): PNG always, JPEG where its
build links libjpeg; other formats, and JPEG without libjpeg, need PIL.
``TrainLoader``'s native backend (the default) gives the same order, crops
and flips as the JAX package's loader on its native backend for the same
seed, and its ``"numpy"`` backend, the plain version (the numpy PNG codec,
numpy crops and flips), those of the JAX loader's PIL path.
"""

from __future__ import annotations

import contextlib
import os
import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from focalnet_tpu_torch.data import native_loader
from focalnet_tpu_torch.data.png import decode_png, to_rgb, write_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"
_EXTS = ("png", "jpg", "jpeg")
BACKENDS = ("native", "numpy")
# every PNG row filter in turn, as PNG writers mix them in photographs
SYNTHETIC_FILTERS = (0, 1, 2, 3, 4)


def _native_size(path: str):
    """The (max_h, max_w) to decode ``path`` with natively: a PNG's own size,
    JAX's 4096 limit for a JPEG where the build links libjpeg.  ``None``
    for a format that the build lacks (PIL reads it)."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head.startswith(_PNG_SIGNATURE):
        w, h = struct.unpack(">II", head[16:24]) if len(head) == 24 else (1, 1)
        return max(h, 1), max(w, 1)
    if head.startswith(_JPEG_MAGIC) and native_loader.has_jpeg():
        return 4096, 4096
    return None


def _load_image_u8(path: str) -> np.ndarray:
    """uint8 RGB (H, W, 3), the serving upload format: the native decode
    (gray replicated, alpha dropped, as PIL's ``convert("RGB")`` does), or
    PIL for a format the build lacks."""
    size = _native_size(path)
    if size is not None:
        return native_loader.decode_image_u8(path, *size)
    with pil_image(path).open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _load_image(path: str) -> np.ndarray:
    """float32 RGB (H, W, 3) in [0, 1], ``u8 / 255.0``: the native decode,
    or PIL for a format the build lacks."""
    size = _native_size(path)
    if size is not None:
        return native_loader.decode_image(path, *size)
    with pil_image(path).open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _load_image_plain(path: str) -> np.ndarray:
    """float32 RGB (H, W, 3) in [0, 1] by the plain path: the numpy PNG
    codec, PIL for other formats."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        img = to_rgb(decode_png(data))
    else:
        with pil_image(path).open(path) as im:
            img = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return img.astype(np.float32) / 255.0


def pil_image(path: str):
    """PIL's ``Image`` module, for a non-PNG ``path``; a clear error without PIL."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: only PNG is read and written without PIL, which is not "
            "installed") from None
    return Image


def _check_images(names: List[str]) -> None:
    for x in names:
        if x.split(".")[-1] not in _EXTS:
            raise ValueError(f"non-image file in hazy dir: {x!r}")


class ResideDataset:
    """Paired hazy/GT dataset with the RESIDE pairing rule."""

    def __init__(self, image_dir: str):
        self.image_dir = image_dir
        self.image_list = sorted(os.listdir(os.path.join(image_dir, "hazy")))
        _check_images(self.image_list)

    def __len__(self):
        return len(self.image_list)

    def gt_name(self, hazy_name: str) -> str:
        return hazy_name.split("_")[0] + ".png"

    def paths(self, idx: int) -> Tuple[str, str]:
        name = self.image_list[idx]
        return (os.path.join(self.image_dir, "hazy", name),
                os.path.join(self.image_dir, "gt", self.gt_name(name)))

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        hazy, gt = self.paths(idx)
        return _load_image(hazy), _load_image(gt), self.image_list[idx]


def paired_random_crop(img, label, size: int, rng: np.random.Generator):
    h, w = img.shape[:2]
    if h < size or w < size:  # zero-pad first, as PairRandomCrop(pad_if_needed)
        ph, pw = max(0, size - h), max(0, size - w)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        label = np.pad(label, ((0, ph), (0, pw), (0, 0)))
        h, w = img.shape[:2]
    i = int(rng.integers(0, h - size + 1))
    j = int(rng.integers(0, w - size + 1))
    return img[i : i + size, j : j + size], label[i : i + size, j : j + size]


def paired_hflip(img, label, rng: np.random.Generator, p: float = 0.5):
    if rng.random() < p:
        return img[:, ::-1], label[:, ::-1]
    return img, label


class TrainLoader:
    """Shuffled, augmented, prefetched training iterator.

    Yields (hazy, gt) float32 arrays (batch, crop, crop, 3).  An epoch is
    len(dataset) // batch batches: the partial last batch is dropped, as the
    JAX loader does.  A producer thread assembles ``prefetch`` batches ahead.
    ``backend="native"`` (the default) decodes, crops and flips each batch
    in ``num_workers`` C++ threads (:func:`.native_loader.load_pair_batch`;
    an image smaller than the crop raises); ``"numpy"``, the plain version,
    decodes with the numpy codec and crops (zero-padding a small image) and
    flips with numpy draws, each example in a pool of ``num_workers``
    threads.  ``rows`` (indices into each batch) makes it decode and yield
    only those rows of every batch, with the crops and flips of the whole
    batch (a data-parallel rank's share; with no rows, empty arrays)."""

    def __init__(self, path: str, batch_size: int, num_workers: int = 8,
                 crop: int = 256, seed: int = 1234, prefetch: int = 4, rows=None,
                 backend: str = "native"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        self.ds = ResideDataset(os.path.join(path, "train"))
        self.batch_size = batch_size
        self.rows = None if rows is None else np.asarray(rows, dtype=np.int64)
        self.crop = crop
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.backend = backend
        self._epoch_rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ds) // self.batch_size

    def _make_example(self, idx: int, seed: int):
        rng = np.random.default_rng(seed)
        hazy, gt = (_load_image_plain(p) for p in self.ds.paths(idx))
        hazy, gt = paired_random_crop(hazy, gt, self.crop, rng)
        return paired_hflip(hazy, gt, rng)

    def _make_batch(self, ex, idxs, seeds):
        if self.backend == "native":
            paths = [self.ds.paths(i) for i in idxs]
            return native_loader.load_pair_batch(
                [p[0] for p in paths], [p[1] for p in paths], self.crop, seeds,
                self.num_workers)
        pairs = list(ex.map(self._make_example, idxs, seeds))
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._epoch_rng.permutation(len(self.ds))
        seeds = self._epoch_rng.integers(0, 2**31, size=len(self.ds))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with (ThreadPoolExecutor(self.num_workers) if self.backend == "numpy"
                      else contextlib.nullcontext()) as ex:
                    for b in range(len(self)):
                        if stop.is_set():
                            return
                        idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                        if self.rows is not None:
                            idxs = idxs[self.rows]
                        if not len(idxs):  # a rank with no rows of this batch
                            empty = np.zeros((0, self.crop, self.crop, 3), np.float32)
                            q.put((empty, empty))
                            continue
                        q.put(self._make_batch(ex, idxs, seeds[idxs]))
                q.put(None)
            except Exception as e:  # handed to the consumer, which re-raises
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.01)


class EvalLoader:
    """Sequential batch-1 loader over a split.  Yields (hazy, gt, name) with
    hazy and gt (1, H, W, 3) at full size; with ``shard=(i, n)`` only images
    i, i + n, i + 2n, ..."""

    def __init__(self, path: str, split: str = "test", shard=(0, 1)):
        self.ds = ResideDataset(os.path.join(path, split))
        self.shard = shard

    def __len__(self):
        return len(range(self.shard[0], len(self.ds), self.shard[1]))

    def __iter__(self):
        for i in range(self.shard[0], len(self.ds), self.shard[1]):
            hazy, gt, name = self.ds.load_pair(i)
            yield hazy[None], gt[None], name


def make_synthetic_dataset(root: str, n_train: int = 8, n_test: int = 4,
                           hw: Tuple[int, int] = (256, 256), seed: int = 0):
    """Write a RESIDE-layout dataset of random images, with the same pixels
    as the JAX package's ``make_synthetic_dataset`` for the same arguments:
    each GT ``i.png`` gets two hazed versions ``i_k_t.png`` (I = J t + A (1 - t)).
    PNG through the numpy codec, the rows taking the five filters in turn
    (``SYNTHETIC_FILTERS``), as real PNG writers mix them."""
    rng = np.random.default_rng(seed)
    H, W = hw
    for split, n in [("train", n_train), ("test", n_test)]:
        hazy_dir = os.path.join(root, split, "hazy")
        gt_dir = os.path.join(root, split, "gt")
        os.makedirs(hazy_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(n):
            gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
            t = rng.uniform(0.5, 0.9)
            A = rng.uniform(0.7, 1.0)
            hazy = gt * t + A * (1 - t)
            write_png(os.path.join(gt_dir, f"{i}.png"), (gt * 255).astype(np.uint8),
                      filters=SYNTHETIC_FILTERS)
            for k in range(1, 3):
                write_png(os.path.join(hazy_dir, f"{i}_{k}_{t:.1f}.png"),
                          (hazy * 255).astype(np.uint8), filters=SYNTHETIC_FILTERS)
    return root
