"""The port's channel-split (tensor-parallel) scan on the CPU: one 2-rank gloo
world over a ``(data, model) = (1, 2)`` mesh, spawned once for the module
(``parallel.mesh.spawn``), runs every case (``tests/torch_sp_ranks.py``);
the tests hold its results against the JAX package and against the port
in one process.

- ``selective_scan_tp`` (forward and gradients), whole-group (G = 2 over 2
  ranks, with ``y_accum``) and sub-group (G = 1: each rank a half of the
  group's channels, B and C replicated), against JAX's on a 2-device CPU
  mesh (``backend="chunked"``), at ``tests/test_parallel.py``'s tolerances:
  rtol 1e-4 / atol 1e-5 forward, rtol 1e-3 / atol 1e-5 x the largest
  gradient;
- the channel-split SS2D against the port's dense SS2D, same tolerances, at
  v4 and at a variant (``v4softmaxnozact``, v2 init);
- one train step of the tiny model with channel-split scans against one
  process: loss within rtol 1e-5, gradients within 1e-3 max|g| + 1e-5, the
  ranks' parameters equal bit for bit;
- without a world: ``mesh_free`` clears a tp mesh, and ``seq_axis`` with
  ``tp_axis`` raises, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from focalnet_tpu.parallel import selective_scan_tp as jax_selective_scan_tp
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.models.mimounet import mesh_free
from focalnet_tpu_torch.models.ss2d import SS2D
from focalnet_tpu_torch.parallel import Mesh, spawn

import torch_sp_ranks as ranks

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
SS2D_KW = dict(d_model=16, d_state=4, scan_backend="chunked")
# a variant on the sharded path: another out-norm, the z flags, other laws
VARIANT_KW = dict(SS2D_KW, forward_type="v4softmaxnozact", initialize="v2")


def _scan_case(G, reverse, accum, batch=2, dim=16, N=4, L=96, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    n = lambda *s: rng.standard_normal(s)
    arrays = dict(
        u=f32(0.5 * n(batch, dim, L)), delta=f32(0.5 * rng.uniform(size=(batch, dim, L))),
        A=f32(-0.5 - rng.uniform(size=(dim, N))), B=f32(0.5 * n(batch, G, N, L)),
        C=f32(0.5 * n(batch, G, N, L)), D=f32(n(dim)), delta_bias=f32(0.3 * n(dim)),
        y_accum=f32(n(batch, dim, L)),
    )
    return arrays, f32(n(batch, dim, L)), reverse, accum


SCAN_CASES = {"whole_group": dict(G=2, reverse=False, accum=True),
              "sub_group": dict(G=1, reverse=True, accum=False)}


def _ss2d_case(kw=SS2D_KW):
    with torch.random.fork_rng():  # the layers' default init draws from it
        torch.manual_seed(4)
        ss2d = SS2D(**kw)
    ss2d.reset_parameters_from(torch.Generator().manual_seed(4))
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 16)).astype(np.float32) * 0.5
    return kw, {k: v.numpy() for k, v in ss2d.state_dict().items()}, x


def _train_case():
    rng = np.random.default_rng(6)
    return 17, rng.uniform(size=(2, 32, 32, 3)).astype(np.float32), \
        rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    cases = {k: _scan_case(**kw) for k, kw in SCAN_CASES.items()}
    return spawn(ranks.run_tp_cases, (1, 2), "cpu", timeout_s=240, axes=("data", "model"),
                 args=(cases, {"ss2d": _ss2d_case(), "ss2d_variant": _ss2d_case(VARIANT_KW)},
                       _train_case()))


def _jax_scan(arrays, dy, reverse, accum):
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("model",))
    names = ranks.SCAN_NAMES + (("y_accum",) if accum else ())

    def loss(*ops):
        y = jax_selective_scan_tp(*ops[:7], True, mesh=mesh, backend="chunked",
                                  reverse=reverse, y_accum=ops[7] if accum else None)
        return jnp.sum(y * dy), y

    grads, y = jax.jit(jax.grad(loss, argnums=tuple(range(len(names))), has_aux=True))(
        *(jnp.asarray(arrays[k]) for k in names))
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_tp_scan_matches_jax(world, case):
    arrays, dy, reverse, accum = _scan_case(**SCAN_CASES[case])
    y_j, grads_j = _jax_scan(arrays, dy, reverse, accum)
    scale = max(float(np.abs(g).max()) for g in grads_j)
    names = ranks.SCAN_NAMES + (("y_accum",) if accum else ())
    for r in world:
        y, grads = r[case]
        np.testing.assert_allclose(y, y_j, **FWD_TOL)
        assert len(grads) == len(grads_j) == len(names)
        for name, g, g_j in zip(names, grads, grads_j):
            np.testing.assert_allclose(g, g_j, rtol=1e-3, atol=1e-5 * scale, err_msg=name)


def _check_ss2d_against_dense(world, name, kw=SS2D_KW):
    kw, state, x = _ss2d_case(kw)
    dense = SS2D(**kw)
    dense.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    y, grads = ranks.ss2d_out_grads(dense, x)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for r in world:
        y_tp, grads_tp = r[name]
        np.testing.assert_allclose(y_tp, y, **FWD_TOL)
        assert set(grads_tp) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(grads_tp[k], g, rtol=1e-3, atol=1e-5 * scale, err_msg=k)


def test_tp_ss2d_matches_dense(world):
    _check_ss2d_against_dense(world, "ss2d")


def test_tp_ss2d_variant_matches_dense(world):
    """``v4softmaxnozact`` on the channel-split path against the dense path."""
    _check_ss2d_against_dense(world, "ss2d_variant", VARIANT_KW)


def test_tp_train_step_matches_one_process(world):
    seed, hazy, gt = _train_case()
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      **ranks.TINY)
    loss, grads, _ = ranks.train_step(model, hazy, gt)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    (loss0, grads0, params0), (loss1, _, params1) = (r["train"] for r in world)
    assert loss0 == loss1
    np.testing.assert_allclose(loss0, loss, rtol=1e-5)
    assert len(grads0) == len(grads) == 308
    for k, g in grads.items():
        np.testing.assert_allclose(grads0[k], g, rtol=0, atol=1e-3 * scale + 1e-5, err_msg=k)
        np.testing.assert_array_equal(params0[k], params1[k], err_msg=k)


def test_mesh_free_clears_a_tp_mesh():
    """Within ``mesh_free`` a model built on a tp mesh runs its dense path
    (no process group is needed: nothing is collective) and gives the
    mesh-free model's output; afterwards its SS2Ds hold the mesh again."""
    mesh = Mesh(shape={"data": 1, "model": 2}, rank=0, device=torch.device("cpu"),
                backend="gloo")
    tp = build_net("1mlp_g2", device="cpu", seq_mesh=mesh, tp_axis="model", data_axis="data",
                   **ranks.TINY)
    dense = build_net("1mlp_g2", device="cpu", **ranks.TINY)
    dense.load_state_dict(tp.state_dict())
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    ops = [m for m in tp.modules() if isinstance(m, SS2D)]
    with torch.no_grad(), mesh_free(tp):
        assert all(m.seq_mesh is None for m in ops)
        torch.testing.assert_close(tp(x)[2], dense(x)[2], rtol=0, atol=0)
    assert all(m.seq_mesh is mesh and m.tp_axis == "model" for m in ops)


def test_seq_and_tp_axes_together_raise():
    mesh = Mesh(shape={"data": 1, "seq": 2}, rank=0, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(ValueError, match="seq_axis and tp_axis"):
        SS2D(**SS2D_KW, seq_mesh=mesh, seq_axis="seq", tp_axis="model")
