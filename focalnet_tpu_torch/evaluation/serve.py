"""Resident serving loop over a line protocol (counterpart of
``focalnet_tpu/evaluation/serve.py``).

Protocol (stdin -> stdout, one request per line):

    <input_path>[TAB<output_path>]

answered by one flushed line per request:

    OK<TAB><output_path>        the dehazed image was written
    ERR<TAB><message>           the request failed; the server keeps serving

``READY`` is printed once the model is on the device (in ``--tile`` mode
after one warm-up tile forward; ``warm_shapes`` runs whole-image forwards of
known sizes first).  EOF or an empty line ends the loop.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from focalnet_tpu_torch.data.reside import _load_image_u8
from focalnet_tpu_torch.evaluation.infer import _pad_to_min, tiled_forward, u8_forward
from focalnet_tpu_torch.evaluation.metrics import pad_to_multiple, save_image
from focalnet_tpu_torch.utils.device import resolve_device
from focalnet_tpu_torch.utils.meters import Adder


def serve(model, result_dir: str, factor: int = 32, tile: int = 0,
          tile_overlap: int = 32, batch_size: int = 1,
          warm_shapes: Optional[List[Tuple[int, int]]] = None,
          inp=None, out=None, device=None) -> dict:
    """Run the serving loop with ``model`` (a MIMOUNet or a MambaIR) on
    ``device`` (default: the CUDA card; without one this raises).

    ``tile``/``tile_overlap``/``batch_size`` select chop mode
    (:func:`..infer.tiled_forward`; ``batch_size`` batches tiles).
    ``inp``/``out`` default to stdin/stdout."""
    device = resolve_device(device)
    model = model.to(device).eval()
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    os.makedirs(result_dir, exist_ok=True)

    fwd = u8_forward(model, device)

    def respond(*fields):
        out.write("\t".join(fields) + "\n")
        out.flush()

    if tile:
        if tile % 32:
            raise ValueError(f"tile must be a multiple of 32, got {tile}")
        if not 0 <= tile_overlap < tile:
            raise ValueError(f"tile_overlap must be in [0, tile), got {tile_overlap}")
        bs = max(batch_size, 1)
        fwd(np.zeros((bs, tile, tile, 3), np.uint8)).cpu()
    for h, w in warm_shapes or []:
        padded = (-(-h // factor) * factor, -(-w // factor) * factor)
        fwd(np.zeros((1, *padded, 3), np.uint8)).cpu()

    respond("READY")
    served, time_adder = 0, Adder()
    for line in inp:
        line = line.rstrip("\n")
        if not line.strip():
            break
        src, _, dst = line.partition("\t")
        if not dst:
            dst = os.path.join(result_dir, os.path.basename(src))
        try:
            img = _load_image_u8(src)  # (H, W, 3) uint8
            h, w = img.shape[:2]
            tm = time.time()
            if tile:
                pred = tiled_forward(fwd, _pad_to_min(img, tile, tile), tile,
                                     tile_overlap, bs)
            else:
                padded, _ = pad_to_multiple(img[None], factor)
                pred = fwd(padded)[0].cpu().numpy()
            time_adder(time.time() - tm)
            save_image(np.clip(pred[:h, :w], 0.0, 1.0), dst)
            served += 1
            respond("OK", dst)
        except Exception as e:  # keep serving; the client sees the cause
            respond("ERR", f"{type(e).__name__}: {e}")
    return {"count": served,
            "avg_time": time_adder.average() if served else 0.0}
