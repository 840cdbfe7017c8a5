"""The port's Mamba1D, MambaSS2D, cross-scan layout functions and the
``assoc`` and ``matrix`` scan backends against the JAX package's.

- ``causal_conv1d`` (eager JAX), and its causality;
- ``Mamba1D`` on (2, 20, 8) and ``MambaSS2D`` on (1, 6, 8, 8), N = 4, the
  JAX modules on ``scan_backend="ref"`` with random params drawn by numpy
  and carried by ``state_dict_from_jax`` (Mamba1D's raw stacks under the
  JAX converter's names), the port on its CPU path: output and every
  parameter's gradient of ``sum(y * w)``, one jitted ``value_and_grad``
  each, at the model tests' tolerance (rtol 1e-3, atol 3e-4; gradients 1e-3
  of the largest);
- ``cross_scan``, ``cross_merge`` and their ``_1b1`` forms, exactly;
- the ``assoc`` and ``matrix`` backends through both dispatchers at L = 100
  (ragged for the matrix form's chunk of 64), forward and reversed, with
  ``h0`` and the leaving state, against JAX's at rtol 1e-4 / atol 1e-5 (the
  scan tests' fp32 tolerance), and their gradients against the ``ref``
  oracle's (rtol 1e-3, atol 1e-3 of the largest: the matrix form's factors
  w and 1/w cancel in fp32, 1.1e-3 off in dA at a largest gradient of 3.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalnet_tpu.models.mamba1d import Mamba1D as JaxMamba1D
from focalnet_tpu.models.mamba1d import MambaSS2D as JaxMambaSS2D
from focalnet_tpu.models.mamba1d import causal_conv1d as jax_causal_conv1d
from focalnet_tpu.ops.cross_scan import cross_merge as jax_cross_merge
from focalnet_tpu.ops.cross_scan import cross_merge_1b1 as jax_cross_merge_1b1
from focalnet_tpu.ops.cross_scan import cross_scan as jax_cross_scan
from focalnet_tpu.ops.cross_scan import cross_scan_1b1 as jax_cross_scan_1b1
from focalnet_tpu.ops.selective_scan import selective_scan as jax_scan
from focalnet_tpu_torch.models import Mamba1D, MambaSS2D, causal_conv1d
from focalnet_tpu_torch.ops import (
    cross_merge,
    cross_merge_1b1,
    cross_scan,
    cross_scan_1b1,
    selective_scan,
)
from focalnet_tpu_torch.utils import state_dict_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=3e-4)
GRAD_RTOL = 1e-3  # of the largest gradient
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 16, 5), (4, 5), (5,)))
    want = np.asarray(jax_causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    x2 = x.copy()
    x2[:, 9] += 1.0  # position 9 reaches no earlier output
    got2 = causal_conv1d(torch.from_numpy(x2), torch.from_numpy(w))
    np.testing.assert_array_equal(got2[:, :9].numpy(),
                                  causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))[:, :9])


def _params(op, x):
    """Random params of ``op`` in its tree (shapes from ``eval_shape``),
    drawn with numpy: weights N(0, 0.3^2), D near 1, A_log near log(1..N)."""
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(op.init, {"params": jax.random.PRNGKey(0)}, x)

    def draw(path, leaf):
        v = 0.3 * rng.standard_normal(leaf.shape)
        if path[-1].key == "A_logs":
            v += np.log(np.arange(1, leaf.shape[-1] + 1))
        elif path[-1].key == "Ds":
            v += 1.0
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("name", ["Mamba1D", "MambaSS2D"])
def test_mamba_matches_jax(name):
    rng = np.random.default_rng(3)
    if name == "Mamba1D":
        jax_op, op = JaxMamba1D(d_model=8, d_state=4, scan_backend="ref"), Mamba1D(8, d_state=4)
        shape = (2, 20, 8)
    else:
        jax_op, op = (JaxMambaSS2D(d_model=8, d_state=4, scan_backend="ref"),
                      MambaSS2D(8, d_state=4))
        shape = (1, 6, 8, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    params = _params(jax_op, x)

    def loss(p):
        y = jax_op.apply(p, x)
        return jnp.sum(y * w), y

    (_, y_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads_j = state_dict_from_jax(jax.device_get(grads_j))

    sd = state_dict_from_jax(jax.device_get(params))
    raw = ("conv1d_weight", "conv1d_bias", "x_proj_weight", "dt_proj_weight", "dt_proj_bias",
           "A_logs", "Ds")
    prefix = "" if name == "Mamba1D" else "mamba_fwd."
    assert {prefix + k for k in raw} <= set(sd)
    op.load_state_dict(sd, strict=True)
    y = op(torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    grads = {k: p.grad for k, p in op.named_parameters()}
    assert set(grads) == set(grads_j)
    scale = max(float(g.abs().max()) for g in grads_j.values())
    for k, g in grads_j.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def test_cross_scan_functions_match_jax():
    rng = np.random.default_rng(1)
    H, W = 3, 5
    x = rng.standard_normal((2, H, W, 4)).astype(np.float32)
    xs = rng.standard_normal((2, 4, H, W, 4)).astype(np.float32)
    ys = rng.standard_normal((2, 4, H * W, 4)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(cross_scan(t(x)).numpy(), jax_cross_scan(x))
    np.testing.assert_array_equal(cross_scan_1b1(t(xs)).numpy(), jax_cross_scan_1b1(xs))
    np.testing.assert_array_equal(cross_merge_1b1(t(ys), H, W).numpy(),
                                  jax_cross_merge_1b1(ys, H, W))
    np.testing.assert_allclose(cross_merge(t(ys), H, W).numpy(),
                               jax_cross_merge(ys, H, W), rtol=1e-6, atol=1e-6)
    # cross_merge is cross_scan's adjoint
    np.testing.assert_allclose((cross_scan(t(x)) * t(ys)).sum().item(),
                               (t(x) * cross_merge(t(ys), H, W)).sum().item(), rtol=1e-5)


def _scan_case(batch=2, dim=4, N=3, L=100, G=2):
    rng = np.random.default_rng(5)
    f32 = lambda a: np.asarray(a, np.float32)
    n = lambda *s: rng.standard_normal(s)
    return dict(
        u=f32(0.5 * n(batch, dim, L)), delta=f32(0.5 * n(batch, dim, L)),
        A=f32(-0.5 - rng.uniform(size=(dim, N))), B=f32(0.5 * n(batch, G, N, L)),
        C=f32(0.5 * n(batch, G, N, L)), D=f32(n(dim)), delta_bias=f32(0.3 * n(dim)),
    ), f32(0.5 * n(batch, dim, N))


@pytest.mark.parametrize("backend", ["assoc", "matrix"])
@pytest.mark.parametrize("reverse", [False, True])
def test_oracle_backends_match_jax(backend, reverse):
    arrays, h0 = _scan_case()
    args = [arrays[k] for k in SCAN_NAMES[:5]]
    kw = dict(D=arrays["D"], delta_bias=arrays["delta_bias"], delta_softplus=True,
              backend=backend, reverse=reverse)
    torch_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
    scan = jax.jit(jax_scan, static_argnames=("delta_softplus", "backend", "reverse",
                                              "return_state"))
    want = np.asarray(scan(*args, **kw))
    got = selective_scan(*map(torch.from_numpy, args), **torch_kw)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)
    want_y, want_h = scan(*args, h0=h0, return_state=True, **kw)
    got_y, got_h = selective_scan(*map(torch.from_numpy, args), h0=torch.from_numpy(h0),
                                  return_state=True, **torch_kw)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN_TOL)

    # gradients (autograd through the plain ops) against the ref oracle's
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(got.shape).astype(np.float32))
    grads = []
    for b in (backend, "ref"):
        leaves = [torch.tensor(arrays[k], requires_grad=True) for k in SCAN_NAMES]
        h = torch.tensor(h0, requires_grad=True)
        y, h_last = selective_scan(*leaves[:5], D=leaves[5], delta_bias=leaves[6],
                                   delta_softplus=True, backend=b, reverse=reverse, h0=h,
                                   return_state=True)
        ((y * dy).sum() + h_last.sum()).backward()
        grads.append([t.grad for t in leaves + [h]])
    scale = max(float(w.abs().max()) for w in grads[1])
    for name, g, w in zip(SCAN_NAMES + ("h0",), *grads):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale, msg=name)
