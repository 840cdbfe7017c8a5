"""The port's scan backward against the JAX package's, and its autograd Function.

``selective_scan_bwd_ref`` is the plain version of the backward kernel K2
(``focalnet_tpu/ops/pallas_scan.py::_bwd_kernel``).  The same numpy inputs
go through it (and through ``selective_scan`` with autograd, which pairs the
plain forward with it on CPU tensors) and through ``jax.grad`` of the JAX
package's sequential oracle (``backend="ref"``, the reference the JAX tests
hold the Pallas backward against).  fp32 tolerance rtol 1e-3 / atol 5e-3,
that of ``tests/test_scan_parity.py:103-106``.  Each JAX gradient is jitted
once (about 0.3 s on a CPU, against seconds un-jitted).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalnet_tpu.ops.selective_scan import selective_scan as jax_selective_scan
from focalnet_tpu_torch.ops import selective_scan
from focalnet_tpu_torch.ops.scan_bwd_ref import chunk_states_ref, selective_scan_bwd_ref
from focalnet_tpu_torch.ops.scan_chunked import selective_scan_chunked
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_bwd_cuda,
    selective_scan_cuda,
)

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-3, atol=5e-3)
NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias", "dy_accum")


def _inputs(L, G, batch=2, dim=8, N=4, seed=0):
    """u, delta, A, B, C, D, delta_bias, y_accum, dy as numpy fp32 (A < 0)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return (
        f32(0.5 * rng.standard_normal((batch, dim, L))),
        f32(0.5 * rng.uniform(size=(batch, dim, L))),
        f32(-0.5 - 2.0 * rng.uniform(size=(dim, N))),
        f32(0.5 * rng.standard_normal((batch, G, N, L))),
        f32(0.5 * rng.standard_normal((batch, G, N, L))),
        f32(rng.standard_normal(dim)),
        f32(0.3 * rng.standard_normal(dim)),
        f32(rng.standard_normal((batch, dim, L))),
        f32(rng.standard_normal((batch, dim, L))),
    )


def _jax_grads(arrays, reverse, full):
    """jax.grad of sum(y * dy) through the JAX oracle, for every input."""
    u, delta, A, B, C, D, bias, yacc, dy = arrays

    def loss(u, delta, A, B, C, D, bias, yacc):
        y = jax_selective_scan(
            u, delta, A, B, C, D=D if full else None,
            delta_bias=bias if full else None, delta_softplus=True,
            backend="ref", reverse=reverse, y_accum=yacc if full else None)
        return jnp.sum(y * dy)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(
        u, delta, A, B, C, D, bias, yacc)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("full", [True, False], ids=["D_bias_yaccum", "bare"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L,G", [(64, 1), (200, 2)])  # 200: a ragged tail
def test_plain_backward_matches_jax(L, G, reverse, full):
    arrays = _inputs(L, G)
    want = _jax_grads(arrays, reverse, full)
    t = [torch.from_numpy(a) for a in arrays]
    u, delta, A, B, C, D, bias, yacc, dy = t
    if not full:
        D = bias = yacc = None
    direct = selective_scan_bwd_ref(u, delta, A, B, C, D, bias, dy,
                                    delta_softplus=True, reverse=reverse)
    inputs = [x.clone().requires_grad_() for x in (u, delta, A, B, C, D, bias, yacc)
              if x is not None]
    extra = dict(zip(("D", "delta_bias", "y_accum"), inputs[5:]))
    y = selective_scan(*inputs[:5], **extra, delta_softplus=True,
                       backend="chunked", reverse=reverse)
    assert y.grad_fn is not None and "SelectiveScanFn" in type(y.grad_fn).__name__
    through_fn = torch.autograd.grad(y, inputs, dy)
    for i, name in enumerate(NAMES[: len(inputs)]):
        np.testing.assert_allclose(through_fn[i].numpy(), want[i], **GRAD_TOL,
                                   err_msg=f"{name} (autograd Function)")
        if i < 7:
            np.testing.assert_allclose(direct[i].numpy(), want[i], **GRAD_TOL,
                                       err_msg=f"{name} (selective_scan_bwd_ref)")
    if not full:
        assert direct[5] is None and direct[6] is None


def _torch_inputs(L=300, G=2, dtype=torch.float32, seed=1):
    arrays = _inputs(L, G, seed=seed)
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 1, 3, 4):  # u, delta, B, C in the input dtype
        t[i] = t[i].to(dtype)
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_autograd_function_matches_autograd_through_chunked(reverse, accum, dtype):
    """The plain Function (plain forward + plain adjoint) against autograd
    through the chunked scan: the same sums in another order, so fp32
    agrees to rounding (bf16 inputs: the gradients of u, delta, B, C come back
    rounded to bf16 the same way on both sides)."""
    u, delta, A, B, C, D, bias, yacc, dy = _torch_inputs(dtype=dtype)
    leaves = [x.clone().requires_grad_() for x in (u, delta, A, B, C, D, bias, yacc)]
    lu, ld, lA, lB, lC, lD, lb, ly = leaves
    kw = dict(D=lD, delta_bias=lb, delta_softplus=True)
    y = selective_scan(lu, ld, lA, lB, lC, backend="chunked", reverse=reverse,
                       y_accum=ly if accum else None, **kw)
    got = torch.autograd.grad(y, leaves if accum else leaves[:7], dy)

    flip = (lambda x: torch.flip(x, dims=(-1,))) if reverse else (lambda x: x)
    y2 = flip(selective_scan_chunked(flip(lu), flip(ld), lA, flip(lB), flip(lC), **kw))
    if accum:
        y2 = y2 + ly
    want = torch.autograd.grad(y2, leaves if accum else leaves[:7], dy)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g, w, **tol, msg=name)


def test_autograd_function_honours_needs_input_grad(monkeypatch):
    """Only the inputs that need a gradient get one; with only y_accum
    needing one, no backward scan runs and its gradient is dy itself."""
    dispatch = importlib.import_module("focalnet_tpu_torch.ops.selective_scan")

    u, delta, A, B, C, D, bias, yacc, dy = _torch_inputs()
    lu = u.clone().requires_grad_()
    y = selective_scan(lu, delta, A, B, C, D=D, delta_bias=bias,
                       delta_softplus=True, backend="chunked")
    (gu,) = torch.autograd.grad(y, [lu], dy)
    want = selective_scan_bwd_ref(u, delta, A, B, C, D, bias, dy, True)[0]
    torch.testing.assert_close(gu, want)

    def no_scan(*args, **kwargs):
        raise AssertionError("the backward scan ran for y_accum alone")

    monkeypatch.setattr(dispatch, "selective_scan_bwd_ref", no_scan)
    ly = yacc.clone().requires_grad_()
    y = selective_scan(u, delta, A, B, C, D=D, delta_bias=bias,
                       delta_softplus=True, backend="chunked", y_accum=ly)
    (gy,) = torch.autograd.grad(y, [ly], dy)
    assert torch.equal(gy, dy)


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_wrappers_take_plain_versions_for_cpu_tensors(reverse):
    """On CPU tensors the backward wrapper is the plain adjoint and the
    forward wrapper's chunk states are the plain ones; nothing is launched."""
    u, delta, A, B, C, D, bias, _, dy = _torch_inputs(L=600, G=1)
    before = (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches)
    y, hchk = selective_scan_cuda(u, delta, A, B, C, D=D, delta_bias=bias,
                                  delta_softplus=True, reverse=reverse,
                                  chunk_states=True)
    assert hchk.shape == (2, 8, 3, 4)
    torch.testing.assert_close(
        hchk, chunk_states_ref(u, delta, A, B, bias, True, reverse))
    got = selective_scan_bwd_cuda(u, delta, A, B, C, D, bias, dy, hchk, True, reverse)
    want = selective_scan_bwd_ref(u, delta, A, B, C, D, bias, dy, True, reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    assert (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches) == before


def test_chunk_states_are_the_scan_states_at_chunk_edges():
    """``chunk_states_ref``: the state entering each 256-item chunk, from the
    left, or under ``reverse`` from the right (zero for the first chunk the
    scan meets)."""
    u, delta, A, B, C, _, bias, _, _ = _torch_inputs(L=600, G=1)
    from focalnet_tpu_torch.ops.scan_chunked import scan_states
    from focalnet_tpu_torch.ops.scan_ref import _prepare

    uf, dt, Af, Bf, _, _ = _prepare(u, delta, A, B, C, None, bias, True)
    a = torch.exp(dt[:, :, None] * Af[None, :, :, None])
    h = scan_states(a, dt[:, :, None] * Bf * uf[:, :, None])  # G = 1
    fwd = chunk_states_ref(u, delta, A, B, bias, True, reverse=False)
    assert torch.equal(fwd[:, :, 0], torch.zeros_like(fwd[:, :, 0]))
    torch.testing.assert_close(fwd[:, :, 1], h[..., 255])
    torch.testing.assert_close(fwd[:, :, 2], h[..., 511])
    hr = torch.flip(scan_states(torch.flip(a, (-1,)),
                                torch.flip(dt[:, :, None] * Bf * uf[:, :, None], (-1,))),
                    (-1,))  # hr[..., p]: the reverse state after position p
    rev = chunk_states_ref(u, delta, A, B, bias, True, reverse=True)
    torch.testing.assert_close(rev[:, :, 0], hr[..., 256])
    torch.testing.assert_close(rev[:, :, 1], hr[..., 512])
    assert torch.equal(rev[:, :, 2], torch.zeros_like(rev[:, :, 2]))
