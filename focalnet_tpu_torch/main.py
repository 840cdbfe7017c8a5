"""CLI entry point of the port (counterpart of ``focalnet_tpu/main.py``).

Usage:
    python -m focalnet_tpu_torch.main --data_dir dataset/ITS    # --mode train
    python -m focalnet_tpu_torch.main --mode test --test_model <reference .pkl> [--save_image]
    python -m focalnet_tpu_torch.main --mode infer --input <image or dir> --test_model <pkl>
    python -m focalnet_tpu_torch.main --mode serve --test_model <reference .pkl>
    python -m focalnet_tpu_torch.main --flops_report --mode serve
    python -m focalnet_tpu_torch.main --preset 1mlp --compute_dtype bfloat16 --ssm_out_dtype bfloat16
    python -m focalnet_tpu_torch.main --mesh_shape 2 --batch_size 4         # data parallel
    python -m focalnet_tpu_torch.main --mode test --mesh_shape 1,2 --test_model <pkl>

``--preset`` takes the JAX CLI's four (``baseline``, ``1mlp``, ``1mlp_g2``,
``1mlp_g4``) in every mode; ``--compute_dtype bfloat16 --ssm_out_dtype
bfloat16`` is the JAX package's bf16 training recipe.

The defaults are the JAX CLI's: ``--mode train``, ``--test_model
results/weights/Best.pkl`` (the reference-format counterpart of JAX's Orbax
``results/weights/Best``); ``--flops_report`` prints its report and then
runs ``--mode``.  Every mode writes the model and train configs to
``<model_save_dir>/config.json`` and makes ``--result_dir``, as the JAX CLI
does.  Runs on the CUDA card unless ``--device cpu``.

``--mesh_shape`` has the JAX CLI's meaning in every mode.  A mesh of more
than one point runs the mode on that many ranks, one process each
(``parallel.mesh.spawn``); rank 0 prints, logs and writes files, and
:func:`main` returns each rank's report (its kernel launches, peak memory
and the mode's result).  A mesh of one point (``1``, ``1,1``) runs in this
process, as on one JAX device.

- ``--mode train``: ``N`` trains data parallel on N ranks (each takes its
  rows of every batch; the gradients are averaged); ``D,M`` dp x sp (the
  batch over D, every SS2D scan sharded over L across M); ``''`` (the
  default) is data parallel over the largest device count dividing
  ``--batch_size`` (the cards, or 1 under ``--device cpu``).
- ``--mode test`` (batch 1): ``1,M`` is sequence-parallel; ``N`` runs
  without a mesh; ``D,M`` with D > 1 prints JAX's note and runs without one.
- ``--mode infer``: ``N`` shards every batch over N ranks, ``1,M`` shards
  the scans over L, ``D,M`` both; a ``--valid_batch`` of 1 is raised to the
  data axis's size (with JAX's note).
- ``--mode serve``: the mesh is ignored; the mesh-free model serves.

Every mode writes the shape and its axes to ``config.json`` as the JAX CLI
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import math
import os
import random
import sys

import numpy as np
import torch


def main(argv=None, inp=None, out=None):
    """Parse ``argv`` and run; ``inp``/``out`` replace stdin/stdout (serve).
    Returns the report's numbers under ``--flops_report``, else what the
    mode returns; on a mesh of ranks each rank's report (a list by rank, or
    this rank's report when a process group is already running)."""
    args = parse_args(argv)
    shape = _ranks_shape(args)
    if shape is None:
        return _main(args, None, inp, out)
    return _run_mesh(args, argv, shape)


def _ranks_shape(args):
    """The mesh that ``args`` runs on ranks, as the JAX CLI reads
    ``--mesh_shape`` for the mode; None to run in this process."""
    from focalnet_tpu_torch.parallel.mesh import auto_mesh_shape, check_shape, parse_mesh_shape

    shape = parse_mesh_shape(args.mesh_shape)
    if shape is not None:
        check_shape(shape)
    if args.mode == "train" and shape is None:
        cards = max(torch.cuda.device_count(), 1) if args.device != "cpu" else 1
        shape = auto_mesh_shape(args.batch_size, cards)
    if (shape is None or math.prod(shape) == 1 or args.mode == "serve"
            or (args.mode == "test" and (len(shape) == 1 or shape[0] > 1))):
        return None
    return shape


def _run_mesh(args, argv, shape):
    """Run :func:`_rank_main` on every rank of a new process group of
    ``shape``, or on this rank of the one that is running (which may be
    larger: its first ``prod(shape)`` ranks run, the others return None)."""
    import torch.distributed as dist

    from focalnet_tpu_torch.parallel.mesh import make_mesh, rank_device, spawn
    from focalnet_tpu_torch.utils.device import resolve_device

    device_type = resolve_device(args.device or None).type
    if dist.is_initialized():
        mesh = make_mesh(shape, device=rank_device(dist.get_rank(), device_type))
        return None if mesh is None else _rank_main(mesh, argv)
    return spawn(_rank_main, shape, device_type, args=(argv,))


def _rank_main(mesh, argv):
    """One rank of ``--mesh_shape``: the mode on ``mesh``, then this rank's
    report: its K1 and K2 launches (all, and those of the segment API), its
    device's peak memory (GB; None on the CPU), the mode's result (under
    ``--mode train`` a digest of the parameters) and what it printed."""
    from focalnet_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bwd_cuda,
        selective_scan_cuda,
    )

    counters = (selective_scan_cuda, selective_scan_bwd_cuda)
    before = [(c.launches, c.segment_launches) for c in counters]
    printed, stdout = io.StringIO(), sys.stdout
    sys.stdout = _Tee(stdout, printed)
    try:
        result = _main(parse_args(argv), mesh)
    finally:
        sys.stdout = stdout
    if isinstance(result, tuple):  # train: (model, optimizer)
        digest = hashlib.sha256()
        for k, v in result[0].state_dict().items():
            digest.update(k.encode())
            digest.update(v.detach().cpu().contiguous().numpy().tobytes())
        result = {"param_sha256": digest.hexdigest()}
    (fwd, fwd_seg), (bwd, bwd_seg) = [(c.launches - n, c.segment_launches - m)
                                      for c, (n, m) in zip(counters, before)]
    return {
        "rank": mesh.rank, "backend": mesh.backend,
        "launches_fwd": fwd, "launches_bwd": bwd,
        "segment_launches_fwd": fwd_seg, "segment_launches_bwd": bwd_seg,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(mesh.device) / 1e9
                        if mesh.device.type == "cuda" else None),
        "result": result,
        "stdout": printed.getvalue(),
    }


class _Tee(io.TextIOBase):
    """A text stream that writes to every one of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _main(args, mesh, inp=None, out=None):
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    from focalnet_tpu_torch.configs import PRESETS, TrainConfig
    from focalnet_tpu_torch.parallel.mesh import default_axes, parse_mesh_shape
    from focalnet_tpu_torch.utils.device import resolve_device

    device = mesh.device if mesh is not None else resolve_device(args.device or None)
    overrides = {}
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    if args.ssm_out_dtype:
        overrides["ssm_out_dtype"] = args.ssm_out_dtype
    if args.vssg_dim:
        overrides["vssg_dim"] = args.vssg_dim
    if args.ssm_d_state:
        overrides["ssm_d_state"] = args.ssm_d_state
    if args.scan_backend:
        overrides["scan_backend"] = args.scan_backend
    # the JAX CLI's mesh fields: a two-axis shape names the seq axes
    mesh_shape = parse_mesh_shape(args.mesh_shape)
    if mesh_shape is not None and len(mesh_shape) > 1:
        overrides.update(seq_axis="seq", data_axis="data")
    train_cfg = TrainConfig(
        mesh_shape=mesh_shape,
        mesh_axes=default_axes(mesh_shape or (1,)),
        data_dir=args.data_dir, batch_size=args.batch_size,
        learning_rate=args.learning_rate, num_epoch=args.num_epoch,
        grad_accum=args.grad_accum, print_freq=args.print_freq,
        num_worker=args.num_worker, save_freq=args.save_freq,
        valid_freq=args.valid_freq, valid_batch=args.valid_batch,
        crop_size=args.crop_size, seed=args.seed,
        model_save_dir=args.model_save_dir,
    )
    lead = mesh is None or mesh.rank == 0
    if lead:
        os.makedirs(args.model_save_dir, exist_ok=True)
        os.makedirs(args.result_dir, exist_ok=True)
        with open(os.path.join(args.model_save_dir, "config.json"), "w") as f:
            json.dump({"model": dataclasses.asdict(PRESETS[args.preset].replace(**overrides)),
                       "train": dataclasses.asdict(train_cfg)}, f, indent=2)
    report = (_flops_report(args.preset, device, overrides)
              if args.flops_report and lead else None)
    result = _run_mode(args, train_cfg, device, overrides, inp, out, mesh)
    return report if report is not None else result


def _run_mode(args, train_cfg, device, overrides, inp, out, mesh=None):
    """``--mode train``, ``test``, ``infer`` or ``serve``, on this rank of
    ``mesh`` or in this process."""
    from focalnet_tpu_torch.models import build_net

    # the sharded scans' mesh: a run on ranks with a seq axis
    seq_mesh = mesh if mesh is not None and "seq" in mesh.shape else None
    if args.mode == "train":
        from focalnet_tpu_torch.train import train

        model = build_net(args.preset, device=device, seq_mesh=seq_mesh,
                          generator=torch.Generator().manual_seed(args.seed), **overrides)
        return train(model, train_cfg, resume=args.resume or None,
                     log_file=os.path.join(args.model_save_dir, "train.log"), mesh=mesh)

    from focalnet_tpu_torch.utils.convert import load_checkpoint

    if not args.test_model:
        raise SystemExit(f"error: --mode {args.mode} needs --test_model")
    if args.mode == "infer" and not args.input:
        raise SystemExit("error: --mode infer needs --input <image file or directory>")
    if args.mode != "test" and (args.pad_factor % 32 or args.pad_factor <= 0):
        raise SystemExit("error: --pad_factor must be a positive multiple of 32")
    model = build_net(args.preset, device=device, seq_mesh=seq_mesh, **overrides)
    model.load_state_dict(load_checkpoint(args.test_model), strict=True)
    shape = train_cfg.mesh_shape

    if args.mode == "test":
        from focalnet_tpu_torch.evaluation.evaluator import evaluate

        if shape is not None and len(shape) > 1 and shape[0] > 1:
            print("note: --mode test is batch-1; ignoring the dp axis of "
                  "--mesh_shape (use \"1,M\" for sequence-parallel eval)")
        # every rank runs the forwards (they are collective); rank 0 saves
        return evaluate(model, args.data_dir, result_dir=args.result_dir,
                        save_images=args.save_image and (mesh is None or mesh.rank == 0))
    if args.mode == "infer":
        from focalnet_tpu_torch.evaluation.infer import infer

        batch = args.valid_batch
        if shape is not None and math.prod(shape) > 1 and batch == 1:
            # batch 1 cannot shard over the data axis: one image a data rank
            batch = shape[0]
            print(f"note: --valid_batch raised to {batch} (one image per "
                  f"'data'-axis device of --mesh_shape {args.mesh_shape})")
        return infer(model, args.input, args.result_dir, factor=args.pad_factor,
                     batch_size=batch, tile=args.tile, tile_overlap=args.tile_overlap,
                     device=device, mesh=mesh)

    from focalnet_tpu_torch.evaluation.serve import serve

    warm = []
    for tok in filter(None, args.warm_shapes.split(",")):
        h, _, w = tok.lower().partition("x")
        warm.append((int(h), int(w)))
    return serve(model, args.result_dir, factor=args.pad_factor, tile=args.tile,
                 tile_overlap=args.tile_overlap, batch_size=args.valid_batch,
                 warm_shapes=warm, inp=inp, out=out, device=device)


def _flops_report(preset, device, overrides):
    """Params and GFLOPs at 256x256, batch 1 (the JAX package's report): the
    counted term (matrix products and convolutions, by ``FlopCounterMode`` on
    the meta device, which computes nothing) plus the scan cost model, which
    only VSSG blocks have.  Returns the three numbers."""
    from focalnet_tpu_torch.configs import PRESETS
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.utils.flops import mimounet_scan_flops, model_flops

    cfg = PRESETS[preset].replace(**overrides)
    model = build_net(preset, device=device, **overrides)
    n_params = sum(p.numel() for p in model.parameters())
    flops = model_flops(model.to("meta"), torch.zeros(1, 256, 256, 3, device="meta"))
    scan = mimounet_scan_flops(cfg, (256, 256)) if cfg.block_type == "vssg" else 0
    print(f"params: {n_params/1e6:.3f}M")
    print(f"counted flops @256^2: {flops/1e9:.2f} GFLOPs"
          f" + scan {scan/1e9:.2f} GFLOPs (9BLDN model)"
          f" = {(flops+scan)/1e9:.2f} GFLOPs total", flush=True)
    return dict(params=n_params, counted_flops=flops, scan_flops=scan)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="focalnet_tpu_torch")
    p.add_argument("--preset", type=str, default="1mlp_g2",
                   choices=["baseline", "1mlp", "1mlp_g2", "1mlp_g4"])
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test", "infer", "serve"])
    p.add_argument("--input", type=str, default="",
                   help="--mode infer: an image file or a directory of images")
    p.add_argument("--test_model", type=str, default="results/weights/Best.pkl",
                   help="--mode test, infer, serve: reference-format .pkl "
                        "({'model': state_dict, ...})")
    p.add_argument("--save_image", action="store_true",
                   help="--mode test: save the predictions under --result_dir")
    p.add_argument("--result_dir", type=str, default="results/images",
                   help="where --mode test and infer save images, and serve's "
                        "answers go when a request names no output path")
    p.add_argument("--pad_factor", type=int, default=32,
                   help="--mode infer, serve: reflect-pad H, W up to multiples "
                        "of this (multiple of 32); test and validation keep 32")
    p.add_argument("--tile", type=int, default=0,
                   help="--mode infer, serve: overlapping (tile, tile) crops, "
                        "multiple of 32; 0 = whole-image")
    p.add_argument("--tile_overlap", type=int, default=32,
                   help="overlap in pixels between adjacent --tile crops")
    p.add_argument("--valid_batch", type=int, default=1,
                   help="images per forward in validation and --mode infer "
                        "(same-size images; same outputs), tiles per forward "
                        "with --tile; the reference protocol is batch 1")
    p.add_argument("--warm_shapes", type=str, default="",
                   help="comma list of HxW sizes forwarded once before READY")
    # train (the reference's defaults)
    p.add_argument("--data_dir", type=str, default="dataset/ITS")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="accepted and unused, as in the reference, whose Adam "
                        "takes no weight decay")
    p.add_argument("--num_epoch", type=int, default=300)
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--num_worker", type=int, default=8)
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--valid_freq", type=int, default=10)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step: any number dividing "
                        "--batch_size; under a data-parallel --mesh_shape each "
                        "micro-batch is split over the data ranks (some may "
                        "hold none), as the JAX trainer reshards it")
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--resume", type=str, default="",
                   help="rolling checkpoint (model.pkl) to continue from")
    p.add_argument("--model_save_dir", type=str, default="results/weights",
                   help="checkpoints, train.log and config.json; every mode "
                        "(test, infer and serve too) writes config.json here, "
                        "over a training run's")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--mesh_shape", type=str, default="",
                   help="device mesh, comma ints, one process a rank: '' = "
                        "auto DP over all devices dividing batch_size; '4' "
                        "= DP over 4; '2,4' = dp x sp (batch on data, SS2D "
                        "scans sequence-sharded over seq).  --mode train "
                        "takes all three; test runs '1,M' sequence-parallel "
                        "and the others without a mesh (batch 1); infer "
                        "shards its batches over data and its scans over "
                        "seq; serve ignores the mesh")
    p.add_argument("--flops_report", action="store_true",
                   help="print params and GFLOPs at 256x256, then run --mode")
    p.add_argument("--compute_dtype", type=str, default="",
                   choices=["", "float32", "bfloat16"],
                   help="activation compute dtype (params stay fp32)")
    p.add_argument("--ssm_out_dtype", type=str, default="",
                   choices=["", "float32", "bfloat16"],
                   help="scan OUTPUT dtype; '' keeps the reference 'oflex' "
                        "fp32-out contract.  bfloat16 (with --compute_dtype "
                        "bfloat16) halves y/dy HBM traffic; scan state stays "
                        "fp32 either way")
    p.add_argument("--device", type=str, default="",
                   help="'' = the CUDA card (error without one); 'cpu' to run "
                        "on the CPU")
    # architecture overrides (0/"" = the preset's value)
    p.add_argument("--vssg_dim", type=int, default=0)
    p.add_argument("--ssm_d_state", type=int, default=0)
    p.add_argument("--scan_backend", type=str, default="",
                   choices=["", "auto", "cuda", "chunked", "assoc", "ref"])
    return p.parse_args(argv)


if __name__ == "__main__":
    main()
