"""The port's eval slice against the JAX package's: SSIM, ``evaluate``
(``--mode test``), ``infer`` (``--mode infer``), batched validation, the log
scraper and the CLI's config record.

No JAX model is built or jitted.  The JAX loops run on the tiny port
model's predictions: ``evaluate``'s forward is monkeypatched, and ``infer``
gets a ``jax`` whose ``jit`` returns the function unchanged and a stub model
whose ``apply`` is the port's forward.  So both loops see the same
predictions, and what is held is everything around the forward: padding,
bucketing, tiling, cropping, metrics, the printed lines and the saved
pixels.  The forward itself is held against JAX in ``test_torch_model.py``.
"""

import dataclasses
import importlib
import io
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import focalnet_tpu.evaluation.evaluator as jax_evaluator
from focalnet_tpu.configs import PRESETS as JAX_PRESETS
from focalnet_tpu.configs import TrainConfig as JaxTrainConfig
from focalnet_tpu.evaluation import metrics as jax_metrics
from focalnet_tpu.main import parse_args as jax_parse_args
from focalnet_tpu.utils import plot_logs as jax_plot_logs
import focalnet_tpu_torch.train.trainer as trainer_mod
import focalnet_tpu_torch.utils.device as device_mod
from focalnet_tpu_torch.data.png import read_png, read_png_size, write_png
from focalnet_tpu_torch.data.reside import make_synthetic_dataset
from focalnet_tpu_torch.evaluation import evaluate, infer, metrics, validate
from focalnet_tpu_torch.main import main, parse_args
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.utils import plot_logs, save_checkpoint

# the module: the package's ``infer`` attribute is the function
jax_infer_mod = importlib.import_module("focalnet_tpu.evaluation.infer")

torch.set_num_threads(1)

TINY = dict(vssg_dim=16, ssm_d_state=4)
TINY_ARGS = ["--device", "cpu", "--vssg_dim", "16", "--ssm_d_state", "4"]
# SOTS-indoor's 460x620 in small: unaligned, aligned, and one that pads in both
MIXED = [(46, 62), (46, 62), (32, 32), (46, 62), (25, 31)]


@pytest.fixture(scope="module")
def port_model():
    return build_net("1mlp_g2", device="cpu",
                     generator=torch.Generator().manual_seed(1234), **TINY)


def _port_fwd(model):
    """numpy (B, H, W, 3) float -> numpy full-size predictions."""

    def fwd(x):
        with torch.inference_mode():
            return model(torch.from_numpy(np.asarray(x, np.float32)))[2].numpy()

    return fwd


class _PerImage(torch.nn.Module):
    """``model`` run one image of the batch at a time: batch-invariant."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.train(model.training)

    def forward(self, x):
        outs = zip(*(self.model(x[i : i + 1]) for i in range(x.shape[0])))
        return tuple(torch.cat(o) for o in outs)


def _mixed_dataset(root, sizes=MIXED, seed=0):
    """A RESIDE-layout test split with one hazy image a GT, at ``sizes`` in
    this order (the names sort as listed)."""
    rng = np.random.default_rng(seed)
    for d in ("hazy", "gt"):
        os.makedirs(os.path.join(root, "test", d), exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        hazy = (gt * 0.7 + 60).astype(np.uint8)
        write_png(os.path.join(root, "test", "gt", f"{i}.png"), gt)
        write_png(os.path.join(root, "test", "hazy", f"{i}_1_0.7.png"), hazy)
    return root


# --------------------------------------------------------------------- SSIM

@pytest.mark.parametrize("shape,out_hw", [
    ((2, 46, 62, 3), (23, 31)),    # downsampling, uneven bins
    ((1, 32, 32, 3), (64, 64)),    # the aligned-dims quirk: the pool upsamples
    ((1, 25, 31, 3), (40, 50)),
])
def test_adaptive_avg_pool_matches_jax(shape, out_hw):
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    got = metrics.adaptive_avg_pool(x, *out_hw)
    want = jax_metrics.adaptive_avg_pool(x, *out_hw)
    assert got.shape == (shape[0], *out_hw, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("hw", [(46, 62), (32, 64), (460, 620)])
def test_ssim_matches_jax(hw):
    """Plain and pooled SSIM, with the reference's H, W: the next multiple
    of 32 even where h or w is one (32x64 pools to 64x96: upsampling;
    SOTS-indoor's 460x620 to 240x320)."""
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    padded = tuple((s + 32) // 32 * 32 for s in hw)
    if hw[0] < 256:  # unpooled at full size: seconds at 460x620
        np.testing.assert_allclose(metrics.ssim(pred, gt), jax_metrics.ssim(pred, gt),
                                   rtol=1e-6, atol=0)
    got = metrics.eval_ssim(pred, gt, padded)
    np.testing.assert_allclose(got, jax_metrics.eval_ssim(pred, gt, padded),
                               rtol=1e-6, atol=0)
    assert 0 < got[0] < 1
    assert metrics.eval_ssim(gt, gt, padded)[0] == pytest.approx(1.0, abs=1e-6)


# ----------------------------------------------------------------- evaluate

def _mask_time(text):
    text = re.sub(r"time: [0-9.]+", "time: T", text)
    return re.sub(r"Average time: [0-9.]+", "Average time: T", text)


def test_evaluate_matches_jax(tmp_path, port_model, monkeypatch, capsys):
    """``evaluate`` and the JAX loop on the same predictions: the same lines
    (times masked), PSNR and SSIM to 1e-9, the same saved pixels."""
    data = make_synthetic_dataset(str(tmp_path / "data"), n_train=1, n_test=3, hw=(46, 62))
    got = evaluate(port_model, data, result_dir=str(tmp_path / "port"), save_images=True)
    got_out = capsys.readouterr().out
    monkeypatch.setattr(jax_evaluator, "_make_forward",
                        lambda model, params: _port_fwd(port_model))
    want = jax_evaluator.evaluate(None, None, data, result_dir=str(tmp_path / "jax"),
                                  save_images=True)
    want_out = capsys.readouterr().out
    assert _mask_time(got_out) == _mask_time(want_out)
    assert got_out.count("iter PSNR_dehazing") == 6  # 2 hazy images a GT
    assert "The average SSIM is" in got_out
    for k in ("psnr", "ssim"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-9)
    assert got["time"] > 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 6
    for n in names:
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / n)),
                                      read_png(str(tmp_path / "jax" / n)))


# -------------------------------------------------------------------- infer

@pytest.mark.parametrize("kw", [
    dict(batch_size=1),
    dict(batch_size=2),                               # one forward per padded shape
    dict(batch_size=4, tile=32, tile_overlap=8),      # 4 tiles per forward
    dict(batch_size=2, factor=64),
], ids=["batch1", "batch2", "tile", "factor64"])
def test_infer_matches_jax(tmp_path, port_model, monkeypatch, kw):
    """``infer`` and the JAX ``infer`` on the same predictions over mixed
    sizes: the same PNGs, one per input."""
    src = os.path.join(_mixed_dataset(str(tmp_path / "data")), "test", "hazy")
    got = infer(port_model, src, str(tmp_path / "port"), device="cpu", **kw)
    monkeypatch.setattr(jax_infer_mod, "jax",
                        types.SimpleNamespace(jit=lambda f, **_: f))
    fwd = _port_fwd(port_model)
    stub = types.SimpleNamespace(apply=lambda p, x: (None, None, fwd(x)))
    want = jax_infer_mod.infer(stub, None, src, str(tmp_path / "jax"), **kw)
    assert got["count"] == want["count"] == len(MIXED)
    names = sorted(os.listdir(src))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n, (h, w) in zip(names, MIXED):
        a = read_png(str(tmp_path / "port" / n))
        assert a.shape == (h, w, 3)
        np.testing.assert_array_equal(a, read_png(str(tmp_path / "jax" / n)))


def test_infer_batches_by_padded_shape(tmp_path, port_model, monkeypatch):
    """At batch 2 the five mixed files take three forwards (46x62 x3 -> 2 + 1,
    32x32 and 25x31 share 32x32), the partial one at its own size; a single
    file is a valid input; PNG sizes come from the header."""
    src = os.path.join(_mixed_dataset(str(tmp_path / "data")), "test", "hazy")
    shapes = []
    fwd = port_model.forward

    def counting(x):
        shapes.append(tuple(x.shape))
        return fwd(x)

    monkeypatch.setattr(port_model, "forward", counting)
    infer(port_model, src, str(tmp_path / "out"), batch_size=2, device="cpu")
    assert sorted(shapes) == [(1, 64, 64, 3), (2, 32, 32, 3), (2, 64, 64, 3)]
    one = os.path.join(src, sorted(os.listdir(src))[2])
    assert infer(port_model, one, str(tmp_path / "one"), device="cpu")["count"] == 1
    assert read_png_size(one) == (32, 32)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no images"):
        infer(port_model, str(tmp_path / "empty"), str(tmp_path / "x"), device="cpu")


# ---------------------------------------------------------------- validate

@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_validate_matches_jax_batch1(tmp_path, port_model, monkeypatch, capsys,
                                     batch_size):
    """``validate`` at batch 1, 2 and 3 over mixed sizes against the JAX
    batch-1 loop on the port's batch-1 predictions (its forward
    monkeypatched to the port's), with the same printed line.  The
    bucketing, cropping and PSNR are held to 1e-9 dB through a model that
    runs a batch image by image; the batched forward itself rounds
    differently in float32, so with the real model only batch 1 is held to
    1e-9 and batches 2 and 3 to 1e-6."""
    data = _mixed_dataset(str(tmp_path / "data"))
    got = validate(port_model, data, batch_size=batch_size)
    split = validate(_PerImage(port_model), data, batch_size=batch_size)
    got_out = capsys.readouterr().out
    monkeypatch.setattr(jax_evaluator, "_make_forward",
                        lambda model, params: _port_fwd(port_model))
    want = jax_evaluator.validate(None, None, data, batch_size=1)
    assert got_out == 2 * capsys.readouterr().out == 2 * "Start Validation...\n"
    assert split == pytest.approx(want, rel=0, abs=1e-9)
    assert got == pytest.approx(want, rel=0, abs=1e-9 if batch_size == 1 else 1e-6)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_validate_batched_matches_batch1(tmp_path, port_model, batch_size):
    """Batched validation over mixed sizes (buckets flush on a change of
    shape; a partial bucket runs at its own size) gives the batch-1 PSNR."""
    data = _mixed_dataset(str(tmp_path / "data"))
    want = validate(port_model, data)
    got = validate(port_model, data, batch_size=batch_size)
    assert got == pytest.approx(want, rel=0, abs=1e-6)


def test_trainer_validates_at_valid_batch(tmp_path, monkeypatch):
    """``--valid_batch 2`` reaches the trainer's validation, whose line in
    train.log the log scraper reads back with the loss records."""
    calls = []

    def spy(model, data_dir, factor=32, batch_size=1, mesh=None):
        calls.append(batch_size)
        return validate(model, data_dir, factor, batch_size, mesh)

    monkeypatch.setattr(trainer_mod, "validate", spy)
    data, out = str(tmp_path / "data"), str(tmp_path / "w")
    make_synthetic_dataset(data, n_train=2, n_test=2, hw=(32, 32))
    main(["--mode", "train", *TINY_ARGS, "--data_dir", data, "--batch_size", "2",
          "--crop_size", "32", "--num_epoch", "1", "--num_worker", "1",
          "--valid_batch", "2", "--model_save_dir", out,
          "--result_dir", str(tmp_path / "images")])
    assert calls == [2]
    log = os.path.join(out, "train.log")
    got = plot_logs.parse_log(log)
    assert got == jax_plot_logs.parse_log(log)
    assert [e for e, _ in got["psnr"]] == [1.0]
    assert len(got["content"]) == len(got["fft"]) == 1  # the epoch's summary


# ---------------------------------------------------------------- plot_logs

_LOG = """Time:  0.0100 Epoch: 001 Iter:    1/   2 LR: 0.0000340000 Loss content:  0.3000 Loss fft:  1.5000
Time:  0.0100 Epoch: 001 Iter:    2/   2 LR: 0.0000340000 Loss content:  0.2500 Loss fft:  1.2500
EPOCH: 01
Elapsed time: 0.01 Epoch Pixel Loss:  0.2750 Epoch FFT Loss:  1.3750
Start Validation...
001 epoch
 Average PSNR 12.34 dB
EPOCH: 02
Elapsed time: 0.01 Epoch Pixel Loss:  0.2000 Epoch FFT Loss:  1.0000
Resume from 2
EPOCH: 03
Elapsed time: 0.01 Epoch Pixel Loss:  0.1500 Epoch FFT Loss:  0.9000
Start Validation...
003 epoch
 Average PSNR 15.00 dB
"""


@pytest.mark.parametrize("iter_lines", [True, False])
def test_parse_log_matches_jax(tmp_path, iter_lines):
    text = _LOG if iter_lines else "".join(
        ln + "\n" for ln in _LOG.splitlines() if not ln.startswith("Time:"))
    path = str(tmp_path / "train.log")
    with open(path, "w") as f:
        f.write(text)
    got = plot_logs.parse_log(path)
    assert got == jax_plot_logs.parse_log(path)
    assert got["psnr"] == [(1.0, 12.34), (3.0, 15.0)]
    want_x = [0, 1] if iter_lines else [1.0, 2.0, 3.0]
    assert [x for x, _ in got["content"]] == want_x


def test_plot_logs_without_matplotlib(tmp_path, monkeypatch):
    path = str(tmp_path / "train.log")
    with open(path, "w") as f:
        f.write(_LOG)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        plot_logs.plot_logs([path], out=str(tmp_path / "c.png"))


# ---------------------------------------------------------------------- CLI

def test_serve_writes_config_json_as_jax(tmp_path):
    """Every mode writes ``<model_save_dir>/config.json`` ({"model",
    "train"}, as the JAX CLI does) and makes ``--result_dir``; the fields
    the port shares with the JAX configs hold the JAX values for the same
    preset and overrides."""
    ckpt = str(tmp_path / "tiny.pkl")
    save_checkpoint(ckpt, build_net("1mlp_g2", device="cpu", **TINY).state_dict())
    out = str(tmp_path / "w")
    main(["--mode", "serve", *TINY_ARGS, "--test_model", ckpt, "--model_save_dir", out,
          "--result_dir", str(tmp_path / "images"), "--valid_batch", "3"],
         inp=io.StringIO(""), out=io.StringIO())
    assert os.path.isdir(tmp_path / "images")
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    jax_cfg = json.loads(json.dumps({
        "model": dataclasses.asdict(JAX_PRESETS["1mlp_g2"].replace(**TINY)),
        "train": dataclasses.asdict(JaxTrainConfig(model_save_dir=out, valid_batch=3)),
    }))
    assert set(cfg) == set(jax_cfg) == {"model", "train"}
    for part in ("model", "train"):
        assert set(cfg[part]) <= set(jax_cfg[part]), part
        shared = set(cfg[part]) - {"scan_backend"}  # the backends' names differ
        assert {k: cfg[part][k] for k in shared} == {k: jax_cfg[part][k] for k in shared}


@pytest.mark.parametrize("argv", [
    ["--mode", "test", "--save_image", "--test_model", "m.pkl"],
    ["--mode", "infer", "--input", "imgs", "--valid_batch", "2", "--tile", "256"],
])
def test_cli_flags_match_jax(argv):
    port, ref = vars(parse_args(argv)), vars(jax_parse_args(argv))
    for k in ("mode", "input", "save_image", "valid_batch", "tile", "result_dir",
              "data_dir", "pad_factor", "tile_overlap"):
        assert port[k] == ref[k], k


@pytest.mark.parametrize("mode", ["test", "infer"])
def test_eval_modes_raise_without_cuda(tmp_path, monkeypatch, mode):
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    argv = ["--mode", mode, "--test_model", "unused.pkl", "--input", str(tmp_path),
            "--model_save_dir", str(tmp_path / "w")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(SystemExit, match="needs --input"):
        main(["--mode", "infer", *TINY_ARGS, "--model_save_dir", str(tmp_path / "w"),
              "--result_dir", str(tmp_path / "images")])
