"""The port's data parallelism on the CPU: one 4-rank gloo world, spawned once
for the module (``parallel.mesh.spawn``), runs every case
(``tests/torch_sp_ranks.py``); the tests hold its results against the port
in one process, and ``auto_mesh_shape`` against the JAX trainer's rule.

- one train step of the tiny model (DropPath on) data parallel over 4 ranks
  and dp x sp over a ``(2, 2)`` mesh, against the one-process step on the
  whole batch, and over 4 ranks with ``grad_accum`` 2 (micro-batches of 2
  rows: ranks 2 and 3 hold none) against the one-process step over the same
  micro-batches: loss within rtol 1e-5, gradients within 1e-3 max|g| +
  1e-5, the ranks' parameters equal bit for bit;
- ``--mode infer`` at ``--mesh_shape 2`` and ``1,2`` on a directory of
  mixed sizes: JAX's note, the PNGs within 1 LSB of the one-process run;
- ``--mode train`` at ``--mesh_shape 2`` and ``2,2``, two steps: JAX's
  ``Mesh:`` line, the losses and PSNR of the one-process run, the ranks'
  parameters equal, the JAX CLI's ``config.json`` mesh fields; and
  ``--mesh_shape 4 --batch_size 4 --grad_accum 2``, one step, against the
  one-process ``--grad_accum 2`` run.
"""

import ast
import contextlib
import io
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from focalnet_tpu_torch.data.png import read_png, write_png
from focalnet_tpu_torch.data.reside import make_synthetic_dataset
from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.parallel import auto_mesh_shape, spawn
from focalnet_tpu_torch.utils import save_checkpoint

import torch_sp_ranks as ranks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_ARGS = ["--vssg_dim", "16", "--ssm_d_state", "4", "--device", "cpu"]
# image sizes of the infer directory: three padded shapes (64x64 three
# times, 96x64 and 32x96 once), so that three buckets of a batch of 2 hold
# one image, and the second data rank skips their forwards
INFER_HW = [(46, 62), (70, 40), (46, 62), (60, 60), (30, 90)]


def _train_case():
    rng = np.random.default_rng(9)
    return 13, rng.uniform(size=(4, 32, 32, 3)).astype(np.float32), \
        rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)


def _infer_argv(tmp, name, ckpt, shape=None):
    argv = ["--mode", "infer", "--input", str(tmp / "in"), "--test_model", ckpt,
            "--result_dir", str(tmp / name), "--model_save_dir", str(tmp / f"{name}_cfg"),
            *TINY_ARGS]
    return argv + (["--mesh_shape", shape] if shape else [])


def _train_argv(tmp, name, shape=None, accum=False):
    """Two steps at batch 2, or with ``accum`` one at batch 4 over two
    micro-batches."""
    batch = ["--batch_size", "4", "--grad_accum", "2"] if accum else ["--batch_size", "2"]
    argv = ["--mode", "train", "--data_dir", str(tmp / "data"), *batch,
            "--crop_size", "32", "--num_epoch", "1", "--print_freq", "1",
            "--model_save_dir", str(tmp / name), "--result_dir", str(tmp / f"{name}_img"),
            *TINY_ARGS]
    return argv + (["--mesh_shape", shape] if shape else [])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results and the directory of its files."""
    tmp = tmp_path_factory.mktemp("dp")
    make_synthetic_dataset(str(tmp / "data"), n_train=2, n_test=1, hw=(46, 62), seed=1)
    rng = np.random.default_rng(2)
    os.makedirs(tmp / "in")
    for i, (h, w) in enumerate(INFER_HW):
        write_png(str(tmp / "in" / f"im{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
    ckpt = str(tmp / "tiny.pkl")
    save_checkpoint(ckpt, build_net("1mlp_g2", device="cpu", **ranks.TINY).state_dict())
    clis = [("infer_2", _infer_argv(tmp, "infer_2", ckpt, "2")),
            ("infer_1,2", _infer_argv(tmp, "infer_1,2", ckpt, "1,2")),
            ("train_2", _train_argv(tmp, "train_2", "2")),
            ("train_2,2", _train_argv(tmp, "train_2,2", "2,2")),
            ("train_4_accum", _train_argv(tmp, "train_4_accum", "4", accum=True))]
    results = spawn(ranks.run_dp_cases, (4,), "cpu", timeout_s=240,
                    args=(_train_case(), clis))
    return results, tmp, ckpt


@pytest.fixture(scope="module")
def one_process(world):
    """The one-process ``--mode train`` printouts, at batch 2 and at batch 4
    over two micro-batches (its PNGs under ``infer_one``)."""
    _, tmp, ckpt = world
    single = io.StringIO()
    with contextlib.redirect_stdout(single):
        main(_infer_argv(tmp, "infer_one", ckpt))
        main(_train_argv(tmp, "train_one"))
    accum = io.StringIO()
    with contextlib.redirect_stdout(accum):
        main(_train_argv(tmp, "train_one_accum", accum=True))
    return single.getvalue(), accum.getvalue()


def _grads_close(got, want):
    scale = max(float(np.abs(g).max()) for g in want.values())
    assert len(got) == len(want) == 308
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=1e-3 * scale + 1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["dp", "dpsp", "dp_accum"])
def test_train_step_matches_one_process(world, case):
    """The ``(4,)`` and ``(2, 2)`` steps, and the ``(4,)`` step over two
    micro-batches, against one process on the whole batch (over the same
    micro-batches) with the same masks; every rank's parameters equal to the
    bit."""
    seed, hazy, gt = _train_case()
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      **ranks.TINY)
    loss, grads, params = ranks.train_step(model, hazy, gt,
                                           grad_accum=2 if case == "dp_accum" else 1)
    steps = [r[case] for r in world[0]]
    for loss_r, grads_r, params_r in steps:
        np.testing.assert_allclose(loss_r, loss, rtol=1e-5)
        _grads_close(grads_r, grads)
        for k, p in params_r.items():
            np.testing.assert_array_equal(p, steps[0][2][k], err_msg=k)


def _pngs(d):
    return {f: read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("shape", ["2", "1,2"])
def test_sharded_infer_matches_one_process(world, one_process, shape):
    """``--mode infer --mesh_shape`` writes the one-process run's files,
    within 1 LSB; the batch is raised to the data axis with JAX's note (as
    JAX prints it, also where the axis is 1); ranks 2 and 3, outside the
    2-rank mesh, run nothing."""
    results, tmp, _ = world
    want, got = _pngs(tmp / "infer_one"), _pngs(tmp / f"infer_{shape}")
    assert list(got) == list(want) == [f"im{i}.png" for i in range(len(INFER_HW))]
    for f, img in want.items():
        assert np.abs(got[f].astype(int) - img.astype(int)).max() <= 1, f
    reports = [r["cli"][f"infer_{shape}"] for r in results]
    assert reports[2:] == [None, None]
    data = int(shape.split(",")[0])
    note = (f"note: --valid_batch raised to {data} (one image per 'data'-axis device of "
            f"--mesh_shape {shape})")
    assert reports[0]["stdout"].splitlines()[0] == note
    assert f"Dehazed {len(INFER_HW)} images" in reports[0]["stdout"]


def _loss_lines(text):
    return [tuple(float(v) for v in re.findall(r"Loss \w+: +(\S+)", ln))
            for ln in text.splitlines() if ln.startswith("Time:")]


@pytest.mark.parametrize("shape", ["2", "2,2"])
def test_train_cli_matches_one_process(world, one_process, shape):
    """``--mode train --mesh_shape`` for two steps: JAX's ``Mesh:`` line, the
    one-process run's losses and PSNR, equal parameters on every rank, and
    the JAX CLI's mesh fields in ``config.json``."""
    results, tmp, _ = world
    reports = [r["cli"][f"train_{shape}"] for r in results]
    n = int(np.prod([int(s) for s in shape.split(",")]))
    reports, rest = reports[:n], reports[n:]
    assert rest == [None] * (4 - n)
    axes = ("data", "seq")[:len(shape.split(","))]
    mesh = dict(zip(axes, (int(s) for s in shape.split(","))))
    text = reports[0]["stdout"]
    assert text.splitlines()[0] == f"Mesh: {mesh} over {n} devices"
    want = _loss_lines(one_process[0])
    got = _loss_lines(text)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    assert abs(_psnr(text) - _psnr(one_process[0])) <= 0.01
    assert len({r["result"]["param_sha256"] for r in reports}) == 1
    with open(tmp / f"train_{shape}" / "config.json") as f:
        cfg = json.load(f)
    assert cfg["train"]["mesh_shape"] == [int(s) for s in shape.split(",")]
    assert cfg["train"]["mesh_axes"] == list(axes)
    assert cfg["model"]["seq_axis"] == ("seq" if len(axes) == 2 else None)


def _psnr(text):
    return float(re.search(r"Average PSNR (\S+) dB", text).group(1))


def test_train_cli_accum_matches_one_process(world, one_process):
    """``--mode train --mesh_shape 4 --batch_size 4 --grad_accum 2`` (each
    micro-batch of 2 rows on ranks 0 and 1, ranks 2 and 3 with none) runs
    the one-process ``--grad_accum 2`` step: its losses and PSNR, equal
    parameters on every rank."""
    results, _, _ = world
    reports = [r["cli"]["train_4_accum"] for r in results]
    text = reports[0]["stdout"]
    assert text.splitlines()[0] == "Mesh: {'data': 4} over 4 devices"
    got, want = _loss_lines(text), _loss_lines(one_process[1])
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert abs(_psnr(text) - _psnr(one_process[1])) <= 0.01
    assert len({r["result"]["param_sha256"] for r in reports}) == 1


def _jax_auto_mesh_shape(n_devices):
    """The JAX trainer's ``auto_mesh_shape``, compiled from its source with a
    ``jax`` whose ``device_count()`` is ``n_devices`` (importing the trainer
    would load its checkpoint and optimizer libraries, seconds of this
    file's budget)."""
    path = os.path.join(REPO, "focalnet_tpu", "train", "trainer.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "auto_mesh_shape")
    ns = {"jax": types.SimpleNamespace(device_count=lambda: n_devices)}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["auto_mesh_shape"]


def test_auto_mesh_shape_matches_jax():
    """``auto_mesh_shape`` against the JAX trainer's rule, with JAX's device
    count replaced by each count of 1..8, at every batch of 1..16."""
    for n in range(1, 9):
        jax_auto = _jax_auto_mesh_shape(n)
        for batch in range(1, 17):
            assert auto_mesh_shape(batch, n) == jax_auto(batch), (n, batch)
