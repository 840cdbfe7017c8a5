"""Training loop (counterpart of ``focalnet_tpu/train/trainer.py``), on one
card, or on every rank of a process mesh.

The reference recipe: multiscale L1 + 0.1 FFT loss, ``clip_grad_norm_(0.001)``
before every step of Adam (lr 1e-4, betas 0.9/0.999, eps 1e-8, no weight
decay), the per-epoch warm-up + cosine learning rate, rolling / periodic /
best / final checkpoints, validation (``valid_batch`` images a forward) at
epoch 1 and every ``valid_freq`` epochs, and stdout lines in the reference's
log-scraper formats (``Time: ... Epoch: ... Iter: ...``, ``EPOCH: ...``,
``Average PSNR``).  Beside ``train.log`` and ``train.metrics.jsonl`` it writes
the reference's TensorBoard scalars ("Pixel Loss" and "FFT Loss" at each
print on the global-step axis, "PSNR" by epoch) to
``<model_save_dir>/runs`` wherever the ``tensorboard`` package imports, as
the JAX trainer does through torch's writer.

The model trains in ``train()`` mode: DropPath and Dropout draw from one
generator on the card, seeded from ``seed`` and the step index at every
step, so a resumed run draws the masks the uninterrupted one would have (the
JAX loop folds the step index into its key).  Loss values stay on the device until a
print boundary, so the host does not wait for the card every step.

Under a mesh (``parallel.Mesh``) every rank runs this loop on the same
batches of the one-process loader with the same initial weights, and takes
its rows of each: the rank's share of each micro-batch as the JAX trainer
reshards them over ``data`` (:func:`batch_rows`), uneven where the axis does
not divide the micro-batch and none where it exceeds it; the ranks of one
``seq`` or ``model`` row take the same rows and shard their model's SS2D
scans over L or over the channels (``models.ss2d``).  DropPath and Dropout
draw each micro-batch's masks whole and keep the rank's rows, so the masks
are those of the one-process run.  Each rank weights its losses by its
share of the rows (:func:`accumulate`) and :func:`sync_grads` averages the
gradients and the loss over the ranks before each Adam step (a rank
without rows adds zeros, and joins every collective), so that every rank
takes the one-process step, the same to the bit on every rank.  Validation runs the mesh-free model
(``mesh_free``, the JAX trainer's ``eval_model``), the ranks splitting the
images (``evaluation.validate``).  Only rank 0 prints, writes the logs and
the checkpoints, and prints ``Mesh: {...} over N devices`` as the JAX
trainer does.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from focalnet_tpu_torch.configs import TrainConfig
from focalnet_tpu_torch.data.reside import TrainLoader
from focalnet_tpu_torch.evaluation.evaluator import validate
from focalnet_tpu_torch.models.mimounet import mesh_free
from focalnet_tpu_torch.models.ss2d import set_dropout_generator
from focalnet_tpu_torch.parallel.mesh import local_rows
from focalnet_tpu_torch.train.checkpoint import CheckpointManager, restore
from focalnet_tpu_torch.train.losses import multiscale_loss
from focalnet_tpu_torch.train.schedule import warmup_cosine_epoch_lr
from focalnet_tpu_torch.utils.meters import Adder, Timer


def make_optimizer(model, learning_rate: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def optimizer_step(model, optimizer, grad_clip: float = 0.001) -> None:
    """Clip the gradients' global norm to ``grad_clip``, then step."""
    torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
    optimizer.step()


def sync_grads(model, mesh, extra: torch.Tensor) -> torch.Tensor:
    """Average every gradient of ``model`` (zero where a rank has none: it
    held no rows), and the fp32 vector ``extra``, over the ranks of
    ``mesh`` (one flat all-reduce); returns ``extra``'s average."""
    from focalnet_tpu_torch.parallel.mesh import all_reduce

    params = [p for p in model.parameters() if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads] + [extra]), mesh) / mesh.size
    parts = flat.split([g.numel() for g in grads] + [extra.numel()])
    for p, g, v in zip(params, grads, parts):
        g.copy_(v.view_as(g))
        p.grad = g
    return parts[-1]


def _check_accum(batch_size: int, grad_accum: int) -> None:
    if batch_size % grad_accum:
        raise ValueError(f"batch size {batch_size} not divisible by grad_accum {grad_accum}")


def micro_batch_rows(batch_size: int, grad_accum: int, mesh) -> slice:
    """This rank's rows of each of the ``grad_accum`` micro-batches of a
    batch of ``batch_size``: the JAX trainer reshards each micro-batch over
    the ``data`` axis, so the rank takes its :func:`..parallel.mesh.local_rows`
    of ``batch_size / grad_accum`` rows (an uneven split where the axis does
    not divide them; none at all on the last ranks where it exceeds them)."""
    _check_accum(batch_size, grad_accum)
    return local_rows(batch_size // grad_accum, mesh)


def batch_rows(batch_size: int, grad_accum: int, mesh):
    """This rank's rows of every batch of ``batch_size`` (an index array,
    maybe empty; None for all of them): its :func:`micro_batch_rows` of each
    micro-batch, in order, so that the rank's own micro-batches are its
    shares of the one-process run's."""
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return None
    mb, rows = batch_size // grad_accum, micro_batch_rows(batch_size, grad_accum, mesh)
    return np.concatenate([np.arange(j * mb, (j + 1) * mb)[rows] for j in range(grad_accum)])


def accumulate(model, hazy, gt, loss_fn, grad_accum: int = 1, mesh=None,
               batch_size: Optional[int] = None, n_terms: int = 3) -> torch.Tensor:
    """The backward of one step's loss into the gradients of ``model``, and
    the step's ``n_terms`` loss terms (``loss_fn(preds, gt)``, a tuple whose
    first term is the one differentiated) summed over its micro-batches: ``hazy``,
    ``gt`` are this rank's rows of each of ``grad_accum`` micro-batches of a
    batch of ``batch_size`` (default: the rank's rows times the ``data``
    axis).  Each micro-batch's terms are weighted so that, averaged over the
    mesh's ranks and divided by ``grad_accum``, they are the one-process
    step's means: a rank's share of ``n`` of a micro-batch's ``mb`` rows
    counts ``data * n / mb`` (1 where the axis splits every micro-batch
    evenly).  A rank with no rows runs no forward; its sums and gradients
    stay zero."""
    rows = hazy.shape[0]
    n_data = mesh.shape.get("data", 1) if mesh is not None else 1
    whole = rows * n_data if batch_size is None else batch_size
    _check_accum(rows, grad_accum)
    _check_accum(whole, grad_accum)
    weight = n_data * rows / whole
    sums = torch.zeros(n_terms, device=hazy.device)
    if rows:
        for h, g in zip(hazy.chunk(grad_accum), gt.chunk(grad_accum)):
            terms = loss_fn(model(h), g)
            (terms[0] * weight / grad_accum).backward()
            sums += torch.stack([t.detach() for t in terms]) * weight
    return sums


def make_train_step(model, optimizer, fft_weight: float = 0.1,
                    grad_clip: float = 0.001, grad_accum: int = 1, mesh=None,
                    batch_size: Optional[int] = None):
    """One step: loss, gradients, clip, Adam.  ``grad_accum > 1`` splits the
    batch into that many equal micro-batches and averages their gradients
    before the one update (the loss is a per-sample mean, so this is the
    full-batch gradient up to rounding).  Under a ``mesh`` the step takes
    this rank's rows of each micro-batch of a batch of ``batch_size``
    (:func:`batch_rows`; default the rank's rows times the ``data`` axis),
    maybe none, and the gradients and the three means are averaged over its
    ranks (:func:`accumulate`, :func:`sync_grads`) before the update.
    Returns the loss, content and fft means as 0-d tensors on the device."""

    def train_step(hazy, gt):
        optimizer.zero_grad(set_to_none=True)
        sums = accumulate(model, hazy, gt, lambda p, g: multiscale_loss(p, g, fft_weight),
                          grad_accum, mesh, batch_size)
        if mesh is not None:
            sums = sync_grads(model, mesh, sums)
        optimizer_step(model, optimizer, grad_clip)
        loss, content, fft = sums / grad_accum
        return {"loss": loss, "content": content, "fft": fft}

    return train_step


class _ScalarEvents:
    """TensorBoard scalars in ``<log_dir>/events.out.tfevents.*``: the file
    ``torch.utils.tensorboard.SummaryWriter.add_scalar`` writes (a version
    event, then one event a scalar holding a ``simple_value`` summary at its
    step), through tensorboard's record format and plain file writes.
    ``SummaryWriter`` loads TensorFlow, where it is installed, for its file
    layer (about 15 s an import on a CPU host), and the port needs none of
    it."""

    def __init__(self, log_dir: str):
        import socket
        import time

        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.record_writer import RecordWriter

        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._records = RecordWriter(open(os.path.join(log_dir, name), "wb"))
        self._event, self._summary, self._clock = Event, Summary, time.time
        self._write(file_version="brain.Event:2")

    def _write(self, **fields):
        self._records.write(self._event(wall_time=self._clock(), **fields).SerializeToString())
        self._records.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(step=step, summary=self._summary(
            value=[self._summary.Value(tag=tag, simple_value=float(value))]))

    def close(self) -> None:
        self._records.close()


def _summary_writer(log_dir: str):
    """The scalar event writer on ``log_dir``, or None where it cannot be
    made, as where the ``tensorboard`` package is missing (the JAX trainer
    writes the events only where torch's writer, which needs that package,
    imports)."""
    try:
        return _ScalarEvents(log_dir)
    except Exception:  # as the JAX trainer: no writer, no events
        return None


def step_seed(seed: int, step: int) -> int:
    """The DropPath and Dropout generator's seed at global step ``step``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def train(model, cfg: TrainConfig, resume: Optional[str] = None,
          log_file: Optional[str] = None, mesh=None):
    """Train ``model`` (a MIMOUNet on its device) by ``cfg``; ``resume`` is a
    rolling ``model.pkl`` to continue from.  ``mesh``: this rank's
    :class:`..parallel.Mesh` (every rank calls this; ``model``'s scans
    sharded over its ``seq`` or ``model`` axis, if it has one).  Returns
    (model, optimizer)."""
    device = next(model.parameters()).device
    lead = mesh is None or mesh.rank == 0
    if mesh is not None and lead and mesh.size > 1:
        print("Mesh: %s over %d devices" % (dict(mesh.shape), mesh.size))
    optimizer = make_optimizer(model, cfg.learning_rate)
    ckpt = CheckpointManager(cfg.model_save_dir) if lead else None
    start_epoch = 1
    if resume:
        epoch = restore(resume, model, optimizer)
        print("Resume from %d" % epoch)
        start_epoch = epoch + 1

    rows = batch_rows(cfg.batch_size, cfg.grad_accum, mesh)
    loader = TrainLoader(cfg.data_dir, cfg.batch_size, cfg.num_worker,
                         crop=cfg.crop_size, seed=cfg.seed, rows=rows)
    max_iter = len(loader)
    generator = torch.Generator(device=device)
    data_shard = None
    if rows is not None:  # the rank's rows of each micro-batch, whose masks are drawn whole
        micro = micro_batch_rows(cfg.batch_size, cfg.grad_accum, mesh)
        data_shard = (micro.start, cfg.batch_size // cfg.grad_accum)
    set_dropout_generator(model, generator, data_shard)
    model.train()
    train_step = make_train_step(model, optimizer, cfg.fft_loss_weight,
                                 cfg.grad_clip, cfg.grad_accum, mesh, cfg.batch_size)

    logf = open(log_file, "a") if log_file and lead else None
    metricsf = (open(os.path.splitext(log_file)[0] + ".metrics.jsonl", "a")
                if log_file and lead else None)
    tb = _summary_writer(os.path.join(cfg.model_save_dir, "runs")) if log_file and lead else None

    def log(msg):
        print(msg, flush=True)
        if logf:
            logf.write(msg + "\n")
            logf.flush()

    def log_metric(**kv):
        if metricsf:
            metricsf.write(json.dumps(kv) + "\n")
            metricsf.flush()

    epoch_pixel, epoch_fft = Adder(), Adder()
    iter_pixel, iter_fft = Adder(), Adder()
    epoch_timer, iter_timer = Timer("m"), Timer("m")
    best_psnr = -1.0
    try:
        for epoch_idx in range(start_epoch, cfg.num_epoch + 1):
            lr = float(warmup_cosine_epoch_lr(epoch_idx, cfg.learning_rate, cfg.num_epoch,
                                              cfg.warmup_epochs, cfg.lr_min))
            set_lr(optimizer, lr)
            epoch_timer.tic()
            iter_timer.tic()
            pending = []

            def drain():
                if not pending:
                    return
                # one device->host copy for every step since the last one
                for content, fft in torch.stack(
                        [torch.stack([m["content"], m["fft"]]) for m in pending]).tolist():
                    iter_pixel(content)
                    iter_fft(fft)
                    epoch_pixel(content)
                    epoch_fft(fft)
                pending.clear()

            for iter_idx, (hazy, gt) in enumerate(loader.epoch()):
                generator.manual_seed(step_seed(cfg.seed, epoch_idx * max_iter + iter_idx))
                pending.append(train_step(torch.from_numpy(hazy).to(device),
                                          torch.from_numpy(gt).to(device)))
                if (iter_idx + 1) % cfg.print_freq == 0:
                    drain()
                    log("Time: %7.4f Epoch: %03d Iter: %4d/%4d LR: %.10f "
                        "Loss content: %7.4f Loss fft: %7.4f" % (
                            iter_timer.toc(), epoch_idx, iter_idx + 1, max_iter,
                            lr, iter_pixel.average(), iter_fft.average()))
                    log_metric(step=(epoch_idx - 1) * max_iter + iter_idx,
                               pixel_loss=iter_pixel.average(),
                               fft_loss=iter_fft.average(), lr=lr)
                    if tb:  # the reference's global-step axis
                        gs = iter_idx + (epoch_idx - 1) * max_iter
                        tb.add_scalar("Pixel Loss", iter_pixel.average(), gs)
                        tb.add_scalar("FFT Loss", iter_fft.average(), gs)
                    iter_timer.tic()
                    iter_pixel.reset()
                    iter_fft.reset()

            drain()
            if ckpt:
                ckpt.save_rolling(model, optimizer, epoch_idx)
                if epoch_idx % cfg.save_freq == 0:
                    ckpt.save_snapshot(model, epoch_idx)
            log("EPOCH: %02d\nElapsed time: %4.2f Epoch Pixel Loss: %7.4f "
                "Epoch FFT Loss: %7.4f" % (
                    epoch_idx, epoch_timer.toc(),
                    epoch_pixel.average(), epoch_fft.average()))
            epoch_pixel.reset()
            epoch_fft.reset()

            if epoch_idx % cfg.valid_freq == 0 or epoch_idx == 1:
                with mesh_free(model):
                    val = validate(model, cfg.data_dir, batch_size=cfg.valid_batch, mesh=mesh)
                log("%03d epoch \n Average PSNR %.2f dB" % (epoch_idx, val))
                log_metric(epoch=epoch_idx, psnr=val)
                if tb:
                    tb.add_scalar("PSNR", val, epoch_idx)
                if val >= best_psnr:
                    best_psnr = val
                    if ckpt:
                        ckpt.save_best(model, epoch_idx)

        if ckpt:
            ckpt.save_final(model, cfg.num_epoch)
    finally:
        if tb:
            tb.close()
        if logf:
            logf.close()
        if metricsf:
            metricsf.close()
    return model, optimizer
