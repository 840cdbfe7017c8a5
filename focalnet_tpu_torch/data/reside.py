"""RESIDE-ITS paired data pipeline (counterpart of ``focalnet_tpu/data/reside.py``).

Layout ``{root}/{split}/hazy/*.png`` with the GT of hazy ``8_1_0.9.png`` at
``{root}/{split}/gt/8.png`` (the name up to the first ``_``); png, jpg and
jpeg only.  Training takes a paired random crop and a paired horizontal flip;
validation loads pairs one by one at full size.  numpy only: PNG goes
through the port's own codec (:mod:`.png`), other formats need PIL.  The
same seed gives the same order, crops and flips as the JAX package's loader
on its PIL path.  Its native C++ loader is not ported.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from focalnet_tpu_torch.data.png import decode_png, write_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_EXTS = ("png", "jpg", "jpeg")


def _load_image_u8(path: str) -> np.ndarray:
    """uint8 RGB (H, W, 3), the serving upload format.  PNG goes through the
    port's own codec (gray is replicated, alpha dropped, as PIL's
    ``convert("RGB")`` does); other formats need PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        img = decode_png(data)
        if img.shape[2] <= 2:  # gray, gray+alpha
            return np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    with pil_image(path).open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _load_image(path: str) -> np.ndarray:
    """float32 RGB (H, W, 3) in [0, 1]."""
    return _load_image_u8(path).astype(np.float32) / 255.0


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

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        name = self.image_list[idx]
        hazy = _load_image(os.path.join(self.image_dir, "hazy", name))
        gt = _load_image(os.path.join(self.image_dir, "gt", self.gt_name(name)))
        return hazy, gt, name


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
    JAX loader does.  A producer thread decodes ``prefetch`` batches ahead,
    each batch's examples in a pool of ``num_workers`` threads.  ``rows``
    (indices into each batch) makes it decode and yield only those rows of
    every batch, with the crops and flips of the whole batch (a data-parallel
    rank's share; with no rows, empty arrays)."""

    def __init__(self, path: str, batch_size: int, num_workers: int = 8,
                 crop: int = 256, seed: int = 1234, prefetch: int = 4, rows=None):
        self.ds = ResideDataset(os.path.join(path, "train"))
        self.batch_size = batch_size
        self.rows = None if rows is None else np.asarray(rows)
        self.crop = crop
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch_rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ds) // self.batch_size

    def _make_example(self, idx: int, seed: int):
        rng = np.random.default_rng(seed)
        hazy, gt, _ = self.ds.load_pair(idx)
        hazy, gt = paired_random_crop(hazy, gt, self.crop, rng)
        return paired_hflip(hazy, gt, rng)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._epoch_rng.permutation(len(self.ds))
        seeds = self._epoch_rng.integers(0, 2**31, size=len(self.ds))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as ex:
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
                        pairs = list(ex.map(self._make_example, idxs, seeds[idxs]))
                        q.put((np.stack([p[0] for p in pairs]),
                               np.stack([p[1] for p in pairs])))
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
    PNG through the port's codec."""
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
            write_png(os.path.join(gt_dir, f"{i}.png"), (gt * 255).astype(np.uint8))
            for k in range(1, 3):
                write_png(os.path.join(hazy_dir, f"{i}_{k}_{t:.1f}.png"),
                          (hazy * 255).astype(np.uint8))
    return root
