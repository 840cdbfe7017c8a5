"""The port's training slice against the JAX package's.

- One train step of the tiny ``1mlp_g2`` (``vssg_dim=16``, ``ssm_d_state=4``,
  drop_path 0), batch 2 at 32x32: the port's weights go into the JAX model
  through the JAX converter, and the same numpy batch goes through both
  losses and gradients.  The JAX side runs its sequential oracle scan
  (``scan_backend="ref"``) and jits ``value_and_grad`` of the loss once for
  the file, in a module fixture (about 23 s on a CPU); no JAX train step is
  built.  The optimizer (clip + Adam) is checked apart, on the JAX
  gradients, so that Adam's sign-like first step stays out of the gradient
  tolerance.
- The loss functions, schedule, loader and PSNR on shared inputs (numpy or
  eager JAX, nothing jitted).
- The port alone: DropPath's generator, gradient accumulation, batch-1
  validation, and ``--mode train --device cpu`` for 2 epochs plus a resume.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from focalnet_tpu.configs import TrainConfig as JaxTrainConfig
from focalnet_tpu.data.reside import EvalLoader as JaxEvalLoader
from focalnet_tpu.data.reside import TrainLoader as JaxTrainLoader
from focalnet_tpu.data.reside import make_synthetic_dataset as jax_make_dataset
from focalnet_tpu.evaluation.metrics import psnr_mse as jax_psnr
from focalnet_tpu.models import build_net as jax_build_net
from focalnet_tpu.train import losses as jax_losses
from focalnet_tpu.train.schedule import make_schedule as jax_make_schedule
from focalnet_tpu.train.schedule import warmup_cosine_epoch_lr as jax_epoch_lr
from focalnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from focalnet_tpu.train.trainer import set_lr as jax_set_lr
from focalnet_tpu.utils.convert import convert_state_dict
from focalnet_tpu_torch.data.reside import EvalLoader, TrainLoader, make_synthetic_dataset
from focalnet_tpu_torch.evaluation import psnr_mse, psnr_skimage, validate
from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import DropPath, build_net
from focalnet_tpu_torch.train import losses
from focalnet_tpu_torch.train.schedule import make_schedule, warmup_cosine_epoch_lr
from focalnet_tpu_torch.train.trainer import (
    make_optimizer,
    make_train_step,
    optimizer_step,
    set_lr,
)
from focalnet_tpu_torch.utils import load_checkpoint, state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(vssg_dim=16, ssm_d_state=4, drop_path_rate=0.0)
LOSS_RTOL = 1e-5
# per tensor: max |port - jax| <= GRAD_REL * max |jax| + GRAD_ABS.  Measured:
# 1.7e-5 of the tensor's scale (fp32 sums in another order through 12 scan
# cores); the conv biases in front of SCM's InstanceNorm have a true
# gradient of 0, and both sides return about 1e-6 of rounding there.
GRAD_REL, GRAD_ABS = 1e-3, 1e-5


def _port_model():
    return build_net("1mlp_g2", device="cpu",
                     generator=torch.Generator().manual_seed(1234), **TINY)


@pytest.fixture(scope="module")
def jax_step():
    """The port's tiny model, its weights in the JAX model, one batch, and
    the JAX loss terms and gradients on it."""
    port = _port_model()
    jmodel = jax_build_net("1mlp_g2", scan_backend="ref", **TINY)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            np.zeros((1, 32, 32, 3), np.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, report = convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, template)
    assert not report["missing"] and not report["unused"]
    rng = np.random.default_rng(0)
    hazy = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    gt = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)

    def loss_fn(p, h, g):  # as the JAX trainer's loss_fn calls the model
        key = jax.random.PRNGKey(0)
        preds = jmodel.apply(p, h, deterministic=False, train=False,
                             rngs={"droppath": key, "dropout": key})
        total, content, fft = jax_losses.multiscale_loss(preds, g, 0.1)
        return total, (content, fft)

    (total, (content, fft)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, hazy, gt)
    return dict(port=port, params=params, hazy=hazy, gt=gt,
                losses=(float(total), float(content), float(fft)),
                grads=jax.device_get(grads))


def test_train_step_matches_jax(jax_step):
    """Losses, every gradient by reference key, and clip + Adam on the JAX
    gradients against optax's step."""
    port = jax_step["port"]
    port.train()
    preds = port(torch.from_numpy(jax_step["hazy"]))
    total, content, fft = losses.multiscale_loss(preds, torch.from_numpy(jax_step["gt"]))
    np.testing.assert_allclose([total.item(), content.item(), fft.item()],
                               jax_step["losses"], rtol=LOSS_RTOL)

    port.zero_grad(set_to_none=True)
    total.backward()
    want = state_dict_from_jax(jax_step["grads"])
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want) and len(got) == 308
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        assert err <= GRAD_REL * w.abs().max().item() + GRAD_ABS, (k, err)

    # the optimizer alone: the same (JAX) gradients into both.  optax runs on
    # the raveled tree, one vector: the same global norm and per-element
    # Adam, and a jit of one leaf instead of 308.
    lr = float(jax_epoch_lr(1, 1e-4, 300))
    tx = jax_make_optimizer(JaxTrainConfig())
    leaves, treedef = jax.tree.flatten(jax_step["params"])
    flat = np.concatenate([np.ravel(x) for x in leaves])
    flat_grads = np.concatenate([np.ravel(x) for x in jax.tree.leaves(jax_step["grads"])])
    opt_state = jax_set_lr(tx.init(flat), lr)
    new_flat = np.asarray(jax.jit(lambda p, g, s: p + tx.update(g, s, p)[0])(
        flat, flat_grads, opt_state))
    ends = np.cumsum([x.size for x in leaves])
    new_params = jax.tree.unflatten(treedef, [
        chunk.reshape(x.shape) for chunk, x in zip(np.split(new_flat, ends[:-1]), leaves)])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(port)
    set_lr(opt, lr)
    for k, p in port.named_parameters():
        p.grad = want[k].clone()
    optimizer_step(port, opt, 0.001)
    want_params = state_dict_from_jax(new_params)
    for k, v in port.state_dict().items():
        assert not torch.equal(v, before[k]) or torch.equal(want_params[k], before[k]), k
        torch.testing.assert_close(v, want_params[k], rtol=1e-6, atol=1e-9, msg=k)


@pytest.mark.parametrize("factor", [2, 4])
def test_losses_match_jax(factor):
    rng = np.random.default_rng(factor)
    label = rng.uniform(size=(2, 16, 24, 3)).astype(np.float32)
    preds = [rng.uniform(size=(2, 16 // s, 24 // s, 3)).astype(np.float32)
             for s in (4, 2, 1)]
    down, fft, total = jax.jit(lambda preds, label: (  # one compile, not one per op
        jax_losses.bilinear_down(label, factor), jax_losses.fft_l1(preds[2], label),
        jax_losses.multiscale_loss(preds, label, 0.1)))(preds, label)
    np.testing.assert_allclose(
        losses.bilinear_down(torch.from_numpy(label), factor).numpy(),
        np.asarray(down), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        losses.fft_l1(torch.from_numpy(preds[2]), torch.from_numpy(label)).item(),
        float(fft), rtol=1e-5)
    got = losses.multiscale_loss([torch.from_numpy(p) for p in preds],
                                 torch.from_numpy(label), 0.1)
    np.testing.assert_allclose([g.item() for g in got], [float(w) for w in total],
                               rtol=1e-5)


def test_schedule_matches_jax():
    """Every epoch of a 300-epoch run and every step of make_schedule.  Both
    compute in float32; XLA's cos and numpy's differ in the last bit, which
    1 + cos magnifies near the end of the cosine, hence rtol 1e-6.  The
    warm-up and the restart epoch match exactly."""
    epochs = np.arange(1, 301)
    got = warmup_cosine_epoch_lr(epochs, 1e-4, 300)
    want = np.asarray(jax_epoch_lr(epochs, 1e-4, 300))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got[:4], want[:4])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    steps = np.arange(0, 3000, 7)
    np.testing.assert_allclose(make_schedule(1e-4, 300, 10)(steps),
                               np.asarray(jax_make_schedule(1e-4, 300, 10)(steps)),
                               rtol=1e-6)


def test_dataset_and_loaders_match_jax(tmp_path):
    """The same files, order, crops and flips for one seed, two epochs; the
    batch-1 eval loader; the pixels of both synthetic datasets."""
    jax_make_dataset(str(tmp_path / "jax"), n_train=3, n_test=2, hw=(40, 48))
    make_synthetic_dataset(str(tmp_path / "port"), n_train=3, n_test=2, hw=(40, 48))
    jl = JaxTrainLoader(str(tmp_path / "jax"), 2, num_workers=2, crop=32, seed=5,
                        backend="pil")
    pl = TrainLoader(str(tmp_path / "port"), 2, num_workers=2, crop=32, seed=5,
                     backend="numpy")
    assert len(jl) == len(pl) == 3
    for _ in range(2):
        got, want = list(pl.epoch()), list(jl.epoch())
        assert len(got) == len(want) == 3
        for (gh, gg), (wh, wg) in zip(got, want):
            assert gh.shape == (2, 32, 32, 3) and gh.dtype == np.float32
            np.testing.assert_array_equal(gh, wh)
            np.testing.assert_array_equal(gg, wg)
    pairs = list(zip(EvalLoader(str(tmp_path / "port")), JaxEvalLoader(str(tmp_path / "jax"))))
    assert len(pairs) == 4
    for (gh, gg, gn), (wh, wg, wn) in pairs:
        assert gn == wn and gh.shape == (1, 40, 48, 3)
        np.testing.assert_array_equal(gh, wh)
        np.testing.assert_array_equal(gg, wg)


def test_psnr_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(20, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    assert psnr_mse(a, b) == psnr_skimage(a, b) == jax_psnr(a, b)
    assert psnr_mse(a, a) == float("inf")


def test_drop_path_generator():
    """The same generator seed gives the same masks; eval mode is the
    identity; the keep rate is within binomial bounds and kept samples are
    scaled by 1 / keep; training without a generator raises."""
    dp = DropPath(0.25).train()
    x = torch.ones(20000, 3)
    with pytest.raises(RuntimeError, match="needs a generator"):
        dp(x)
    masks = []
    for _ in range(2):
        dp.generator = torch.Generator().manual_seed(7)
        masks.append(dp(x))
    assert torch.equal(masks[0], masks[1])
    dp.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(dp(x), masks[0])
    kept = masks[0][:, 0] != 0
    assert torch.equal(masks[0][kept], torch.full_like(masks[0][kept], 1 / 0.75))
    assert torch.equal(masks[0][~kept], torch.zeros_like(masks[0][~kept]))
    assert torch.equal(masks[0][:, 0], masks[0][:, 2])  # one draw per sample
    rate, sigma = kept.float().mean().item(), math.sqrt(0.75 * 0.25 / 20000)
    assert abs(rate - 0.75) < 5 * sigma
    assert torch.equal(dp.eval()(x), x)


def test_grad_accum_matches_full_batch():
    """Two micro-batches average to the full-batch gradient (port only)."""
    rng = np.random.default_rng(1)
    hazy = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    grads, metrics = [], []
    for accum in (1, 2):
        model = _port_model().train()
        opt = make_optimizer(model, 0.0)  # lr 0: the step leaves the weights
        metrics.append(make_train_step(model, opt, grad_accum=accum)(hazy, gt))
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, w in grads[0].items():
        torch.testing.assert_close(grads[1][k], w, rtol=1e-4, atol=1e-9, msg=k)
    for k in ("loss", "content", "fft"):
        torch.testing.assert_close(metrics[1][k], metrics[0][k], rtol=1e-5, atol=0)


def test_validate_is_mean_psnr(tmp_path):
    make_synthetic_dataset(str(tmp_path), n_train=1, n_test=1, hw=(40, 36))
    model = _port_model().train()
    got = validate(model, str(tmp_path))
    assert model.training  # put back in the mode it was in
    want = []
    model.eval()
    with torch.no_grad():
        for hazy, gt, _ in EvalLoader(str(tmp_path)):
            padded = np.pad(hazy, ((0, 0), (0, 24), (0, 28), (0, 0)), mode="reflect")
            pred = model(torch.from_numpy(padded))[2][0, :40, :36].numpy()
            want.append(psnr_mse(np.clip(pred, 0, 1), gt[0]))
    assert len(want) == 2
    assert got == pytest.approx(np.mean(want), rel=1e-12)


def test_train_cli_two_epochs_then_resume(tmp_path, capsys):
    """``--mode train --device cpu`` at tiny width: 2 epochs with checkpoints
    and validation every epoch, then ``--resume`` for a third."""
    data, out = str(tmp_path / "data"), str(tmp_path / "weights")
    make_synthetic_dataset(data, n_train=2, n_test=1, hw=(32, 32))
    common = ["--mode", "train", "--device", "cpu", "--vssg_dim", "16",
              "--ssm_d_state", "4", "--data_dir", data, "--batch_size", "2",
              "--crop_size", "32", "--print_freq", "1", "--save_freq", "1",
              "--valid_freq", "1", "--num_worker", "2", "--model_save_dir", out]
    main(common + ["--num_epoch", "2"])
    for name in ("model", "model_1", "model_2", "Best", "Final"):
        assert os.path.exists(os.path.join(out, f"{name}.pkl")), name
    assert load_checkpoint(os.path.join(out, "model.pkl"), full=True)["epoch"] == 2
    final2 = load_checkpoint(os.path.join(out, "Final.pkl"))

    main(common + ["--num_epoch", "3", "--resume", os.path.join(out, "model.pkl")])
    stdout = capsys.readouterr().out
    assert "Resume from 2" in stdout
    rolling = load_checkpoint(os.path.join(out, "model.pkl"), full=True)
    assert rolling["epoch"] == 3 and set(rolling) == {"model", "optimizer", "epoch"}
    assert os.path.exists(os.path.join(out, "model_3.pkl"))
    assert any(not torch.equal(v, final2[k]) for k, v in rolling["model"].items())

    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert [f"EPOCH: {e:02d}" in log for e in (1, 2, 3)] == [True] * 3
    assert log.count("Average PSNR") == 3
    with open(os.path.join(out, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "step" in r]
    assert [r["step"] for r in steps] == list(range(6))  # 2 steps an epoch
    assert all(math.isfinite(r["pixel_loss"]) and math.isfinite(r["fft_loss"])
               for r in steps)
    assert [r["epoch"] for r in rows if "psnr" in r] == [1, 2, 3]


def test_train_writes_tensorboard_events_as_jax(tmp_path):
    """``--mode train`` with a log file writes the JAX trainer's TensorBoard
    scalars to ``<model_save_dir>/runs``: "Pixel Loss" and "FFT Loss" at each
    print, at the global step ``iter_idx + (epoch - 1) * max_iter`` (the step
    of ``train.metrics.jsonl``), "PSNR" by epoch, each value the one in
    ``train.metrics.jsonl``."""
    event_accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator",
        reason="no tensorboard package: the trainer writes no events, as JAX's")
    data, out = str(tmp_path / "data"), str(tmp_path / "weights")
    make_synthetic_dataset(data, n_train=2, n_test=1, hw=(32, 32))
    main(["--mode", "train", "--device", "cpu", "--vssg_dim", "16", "--ssm_d_state", "4",
          "--data_dir", data, "--batch_size", "2", "--crop_size", "32", "--print_freq", "1",
          "--num_epoch", "2", "--num_worker", "1", "--model_save_dir", out])
    with open(os.path.join(out, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    acc = event_accumulator.EventAccumulator(os.path.join(out, "runs"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["FFT Loss", "PSNR", "Pixel Loss"]
    events = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
              for tag in ("Pixel Loss", "FFT Loss", "PSNR")}
    steps = [r for r in rows if "step" in r]
    assert [s for s, _ in events["Pixel Loss"]] == [r["step"] for r in steps] == [0, 1, 2, 3]
    for tag, key in (("Pixel Loss", "pixel_loss"), ("FFT Loss", "fft_loss")):
        assert [s for s, _ in events[tag]] == [r["step"] for r in steps]
        np.testing.assert_allclose([v for _, v in events[tag]], [r[key] for r in steps],
                                   rtol=1e-6)  # the events hold fp32
    psnr = [r for r in rows if "psnr" in r]
    assert [s for s, _ in events["PSNR"]] == [r["epoch"] for r in psnr] == [1]
    np.testing.assert_allclose([v for _, v in events["PSNR"]], [r["psnr"] for r in psnr],
                               rtol=1e-6)
