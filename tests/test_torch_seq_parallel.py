"""The port's sequence parallelism on the CPU: one 2-rank gloo world,
spawned once for the module (``parallel.mesh.spawn``), runs every case
(``tests/torch_sp_ranks.py``); the tests hold its results against the JAX
package and against the port on one rank.

- ``selective_scan_seq_sharded`` (forward and gradients) against JAX's on a
  2-device CPU mesh, at ``tests/test_parallel.py``'s tolerances: rtol 1e-4
  / atol 1e-5 forward, rtol 1e-3 / atol 1e-5 x the largest gradient;
- the seq-sharded SS2D against the port's dense SS2D, same tolerances, at
  v4 and at a variant (``v2dwconv3noz``, no depthwise conv, v1 init);
- one ``--mode train`` step of the seq-sharded tiny model against the
  single-rank step: the same loss, gradients and parameters, equal on both
  ranks;
- ``--mode test --mesh_shape 1,2`` against one rank: the same printed PSNR
  and SSIM lines;
- the mesh commands the JAX CLI runs without a mesh run so here, in this
  process (``test 2,1`` with JAX's note, ``test 4``, ``serve 1,2``), and
  ``train 2,2`` and ``infer 1,2`` go to ranks of those shapes (their results
  are checked in ``tests/test_torch_data_parallel.py``'s world).
"""

import contextlib
import io
import os
import re

import focalnet_tpu_torch.parallel.mesh as mesh_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from focalnet_tpu.parallel import selective_scan_seq_sharded as jax_seq_sharded
from focalnet_tpu_torch.data.png import read_png, write_png
from focalnet_tpu_torch.data.reside import make_synthetic_dataset
from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.models.ss2d import SS2D
from focalnet_tpu_torch.parallel import spawn
from focalnet_tpu_torch.utils import save_checkpoint

import torch_sp_ranks as ranks

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
TINY_ARGS = ["--vssg_dim", "16", "--ssm_d_state", "4", "--device", "cpu"]
SS2D_KW = dict(d_model=16, d_state=4, scan_backend="chunked")
# a variant on the sharded path: another out-norm, the z flags, other laws
VARIANT_KW = dict(SS2D_KW, forward_type="v2dwconv3noz", d_conv=1, initialize="v1")


def _scan_case(batch=2, dim=8, N=4, L=128, G=2, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    n = lambda *s: rng.standard_normal(s)
    arrays = dict(
        u=f32(0.5 * n(batch, dim, L)), delta=f32(0.5 * rng.uniform(size=(batch, dim, L))),
        A=f32(-0.5 - rng.uniform(size=(dim, N))), B=f32(0.5 * n(batch, G, N, L)),
        C=f32(0.5 * n(batch, G, N, L)), D=f32(n(dim)), delta_bias=f32(0.3 * n(dim)),
    )
    return arrays, f32(n(batch, dim, L))


def _ss2d_case(kw=SS2D_KW):
    with torch.random.fork_rng():  # the layers' default init draws from it
        torch.manual_seed(3)
        ss2d = SS2D(**kw)
    ss2d.reset_parameters_from(torch.Generator().manual_seed(3))
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 16)).astype(np.float32) * 0.5
    return kw, {k: v.numpy() for k, v in ss2d.state_dict().items()}, x


def _train_case():
    rng = np.random.default_rng(5)
    return 11, rng.uniform(size=(2, 32, 32, 3)).astype(np.float32), \
        rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def sp_inputs(tmp_path_factory):
    """A directory, the tiny dataset in it, and a tiny checkpoint."""
    tmp = tmp_path_factory.mktemp("sp")
    data = make_synthetic_dataset(str(tmp / "data"), n_train=2, n_test=2, hw=(46, 62), seed=0)
    ckpt = str(tmp / "tiny.pkl")
    save_checkpoint(ckpt, build_net("1mlp_g2", device="cpu", **ranks.TINY).state_dict())
    return tmp, data, ckpt


@pytest.fixture(scope="module")
def world(sp_inputs):
    """The 2-rank world's results, with the single-rank test run's printout."""
    tmp, data, ckpt = sp_inputs
    argv = ["--mode", "test", "--data_dir", data, "--test_model", ckpt, *TINY_ARGS]
    results = spawn(ranks.run_cases, (1, 2), "cpu", timeout_s=240, args=(
        _scan_case(), {"ss2d": _ss2d_case(), "ss2d_variant": _ss2d_case(VARIANT_KW)},
        _train_case(),
        argv + ["--mesh_shape", "1,2", "--model_save_dir", str(tmp / "w2"),
                "--result_dir", str(tmp / "i2")]))
    single = io.StringIO()
    with contextlib.redirect_stdout(single):
        main(argv + ["--model_save_dir", str(tmp / "w1"), "--result_dir", str(tmp / "i1")])
    return results, single.getvalue()


def _jax_scan(arrays, dy, reverse):
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("seq",))

    def loss(*ops):
        y = jax_seq_sharded(*ops, True, mesh=mesh, backend="chunked", reverse=reverse)
        return jnp.sum(y * dy), y

    grads, y = jax.jit(jax.grad(loss, argnums=tuple(range(7)), has_aux=True))(
        *(jnp.asarray(arrays[k]) for k in ranks.SCAN_NAMES))
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
def test_seq_sharded_scan_matches_jax(world, reverse):
    arrays, dy = _scan_case()
    y_j, grads_j = _jax_scan(arrays, dy, reverse)
    scale = max(float(np.abs(g).max()) for g in grads_j)
    for r in world[0]:
        y, grads = r[("scan", reverse)]
        np.testing.assert_allclose(y, y_j, **FWD_TOL)
        for name, g, g_j in zip(ranks.SCAN_NAMES, grads, grads_j):
            np.testing.assert_allclose(g, g_j, rtol=1e-3, atol=1e-5 * scale, err_msg=name)


def test_seq_sharded_scan_keeps_no_state_sized_tensor(world):
    """No tensor that the sharded scan's graph saves for its backward is as
    large as one (batch, dim, N, L / 2) state tensor of a rank's block: the
    prefix correction is recomputed in blocks."""
    arrays, _ = _scan_case()
    batch, dim, L = arrays["u"].shape
    state = batch * dim * arrays["A"].shape[1] * L // 2
    for r in world[0]:
        assert r["scan_max_saved"] < state


def _check_ss2d_against_dense(world, name, kw=SS2D_KW):
    kw, state, x = _ss2d_case(kw)
    dense = SS2D(**kw)
    dense.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    y, grads = ranks.ss2d_out_grads(dense, x)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for r in world[0]:
        y_sp, grads_sp = r[name]
        np.testing.assert_allclose(y_sp, y, **FWD_TOL)
        assert set(grads_sp) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(grads_sp[k], g, rtol=1e-3, atol=1e-5 * scale, err_msg=k)


def test_seq_sharded_ss2d_matches_dense(world):
    _check_ss2d_against_dense(world, "ss2d")


def test_seq_sharded_ss2d_variant_matches_dense(world):
    """``v2dwconv3noz`` on the seq-sharded path against the dense path."""
    _check_ss2d_against_dense(world, "ss2d_variant", VARIANT_KW)


def test_sp_train_step_matches_single_rank(world):
    seed, hazy, gt = _train_case()
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      **ranks.TINY)
    loss, grads, params = ranks.train_step(model, hazy, gt)
    (loss0, grads0, params0), (loss1, grads1, params1) = (r["train"] for r in world[0])
    assert loss0 == loss1
    np.testing.assert_allclose(loss0, loss, rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    assert len(grads0) == len(grads) == 308
    for k, g in grads.items():
        np.testing.assert_array_equal(grads0[k], grads1[k], err_msg=k)
        np.testing.assert_array_equal(params0[k], params1[k], err_msg=k)
        np.testing.assert_allclose(grads0[k], g, rtol=1e-3, atol=1e-5 * scale, err_msg=k)
        np.testing.assert_allclose(params0[k], params[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _metric_lines(text):
    """The per-image PSNR / SSIM lines and the average PSNR and SSIM lines
    (the times aside)."""
    return [re.sub(r" time: \S+", "", ln) for ln in text.splitlines()
            if re.match(r"\d+ iter PSNR|The average (PSNR|SSIM)", ln)]


def test_sp_test_cli_matches_single_rank(world):
    results, single = world
    lines = _metric_lines(single)
    assert len(lines) == 2 * 2 * 2 + 2  # 2 GTs x 2 hazy images, two lines each
    # in a running world the CLI returns this rank's report
    assert [r["test_cli"]["rank"] for r in results] == [0, 1]
    assert _metric_lines(results[0]["test_cli"]["stdout"]) == lines
    for r in results:
        report = r["test_cli"]
        assert report["launches_fwd"] == report["launches_bwd"] == 0  # CPU: plain scans
        assert report["peak_mem_gb"] is None


def _no_spawn(*args, **kwargs):
    raise AssertionError("spawned ranks for a command that JAX runs without a mesh")


def _serve(tmp, ckpt, argv, name):
    """One request through ``--mode serve``: its answer line and image."""
    out, answer = io.StringIO(), str(tmp / f"{name}.png")
    main(["--mode", "serve", "--test_model", ckpt, "--model_save_dir", str(tmp / name),
          "--result_dir", str(tmp / name), *TINY_ARGS, *argv],
         inp=io.StringIO(f"{tmp / 'req.png'}\t{answer}\n"), out=out)
    return out.getvalue().splitlines(), read_png(answer)


@pytest.mark.parametrize("mode,shape", [
    ("test", "2,1"), ("train", "2,2"), ("test", "4"), ("infer", "1,2"), ("serve", "1,2"),
])
def test_jax_mesh_commands_run(world, sp_inputs, monkeypatch, mode, shape):
    """Each mesh command runs as the JAX CLI runs it.  ``test 2,1`` prints
    JAX's note and then the no-mesh run's lines, ``test 4`` those lines
    alone, and ``serve 1,2`` answers as the mesh-free server: all three in
    this process, spawning no rank.  ``train 2,2`` and ``infer 1,2`` go to
    ranks of those shapes."""
    tmp, data, ckpt = sp_inputs
    if mode in ("train", "infer"):
        shapes = []
        monkeypatch.setattr(mesh_mod, "spawn",
                            lambda fn, shape, *a, **k: shapes.append(tuple(shape)) or ["ran"])
        argv = ["--mode", mode, "--mesh_shape", shape, "--data_dir", data, "--input", data,
                "--test_model", ckpt, "--model_save_dir", str(tmp / f"{mode}_cfg"), *TINY_ARGS]
        assert main(argv) == ["ran"]
        assert shapes == [tuple(int(n) for n in shape.split(","))]
        return
    monkeypatch.setattr(mesh_mod, "spawn", _no_spawn)
    if mode == "serve":
        rng = np.random.default_rng(8)
        write_png(str(tmp / "req.png"), rng.integers(0, 256, (40, 50, 3), np.uint8))
        lines, img = _serve(tmp, ckpt, ["--mesh_shape", shape], "serve_mesh")
        want_lines, want = _serve(tmp, ckpt, [], "serve_one")
        assert [ln.split("\t")[0] for ln in lines] == [ln.split("\t")[0] for ln in want_lines]
        np.testing.assert_array_equal(img, want)
        return
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(["--mode", "test", "--mesh_shape", shape, "--data_dir", data, "--test_model", ckpt,
              "--model_save_dir", str(tmp / "test_cfg"), "--result_dir", str(tmp / "test_img"),
              *TINY_ARGS])
    text = printed.getvalue()
    note = ('note: --mode test is batch-1; ignoring the dp axis of --mesh_shape '
            '(use "1,M" for sequence-parallel eval)')
    assert (text.splitlines()[0] == note) == (shape == "2,1")
    assert _metric_lines(text) == _metric_lines(world[1])
