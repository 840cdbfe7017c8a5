"""The segment API of the port's scan (``h0`` -> ``h_last`` forward,
``dh_last`` -> ``dh0`` backward) against the JAX package's.

The same numpy inputs go through the port's plain scan and its autograd
Function (``selective_scan(..., backend="chunked", h0=, return_state=True)``:
the plain forward and the plain adjoint, :mod:`focalnet_tpu_torch.ops.scan_bwd_ref`,
the kernels' plain versions) and through JAX's ``selective_scan`` with the
same arguments on its sequential oracle (``backend="ref"``) and its
``jax.vjp``, whose cotangent of ``h_last`` is ``dh_last`` and whose
gradient of ``h0`` is ``dh0``.  Both directions, with and without
``y_accum``, two B/C groups.  Tolerances: rtol 1e-4 / atol 1e-5 forward
(``tests/test_parallel.py``'s segment checks), rtol 1e-3 / atol 5e-3 for the
gradients (``tests/test_torch_scan_bwd.py``'s).  The JAX vjp is jitted once
per direction.  The kernels' counterpart runs on the card
(``tests/test_torch_guards.py::test_segment_kernels_match_plain_on_card``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalnet_tpu.ops.selective_scan import selective_scan as jax_selective_scan
from focalnet_tpu_torch.ops import selective_scan
from focalnet_tpu_torch.ops.scan_bwd_ref import selective_scan_bwd_ref
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_bwd_cuda,
    selective_scan_cuda,
)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=5e-3)
NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias", "h0", "y_accum")


def _inputs(L=77, G=2, batch=2, dim=8, N=4, seed=0):
    """The scan's operands, h0 and y_accum, and the cotangents dy, dh_last,
    as numpy fp32 (A < 0)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    n = lambda *s: rng.standard_normal(s)
    arrays = dict(
        u=f32(0.5 * n(batch, dim, L)), delta=f32(0.5 * rng.uniform(size=(batch, dim, L))),
        A=f32(-0.5 - 2.0 * rng.uniform(size=(dim, N))), B=f32(0.5 * n(batch, G, N, L)),
        C=f32(0.5 * n(batch, G, N, L)), D=f32(n(dim)), delta_bias=f32(0.3 * n(dim)),
        h0=f32(n(batch, dim, N)), y_accum=f32(n(batch, dim, L)),
    )
    return arrays, f32(n(batch, dim, L)), f32(n(batch, dim, N))


@functools.lru_cache(maxsize=None)
def _jax_vjp(reverse):
    def f(u, delta, A, B, C, D, bias, h0, yacc):
        return jax_selective_scan(u, delta, A, B, C, D=D, delta_bias=bias,
                                  delta_softplus=True, backend="ref", reverse=reverse,
                                  h0=h0, return_state=True, y_accum=yacc)

    @jax.jit
    def run(args, dy, dh_last):
        out, vjp = jax.vjp(f, *args)
        return out, vjp((dy, dh_last))

    return run


def _port(arrays, dy, dh_last, reverse, accum, backend="chunked"):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    kw = dict(leaves)
    if not accum:
        kw["y_accum"] = None
    y, h_last = selective_scan(**kw, delta_softplus=True, backend=backend, reverse=reverse,
                               return_state=True)
    ((y * torch.tensor(dy)).sum() + (h_last * torch.tensor(dh_last)).sum()).backward()
    grads = {k: None if t.grad is None else t.grad.numpy() for k, t in leaves.items()}
    return y.detach().numpy(), h_last.detach().numpy(), grads


@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_segment_scan_and_vjp_match_jax(reverse, accum):
    arrays, dy, dh_last = _inputs()
    jax_args = dict(arrays)
    if not accum:
        jax_args["y_accum"] = np.zeros_like(arrays["y_accum"])
    (y_j, h_j), grads_j = _jax_vjp(reverse)(tuple(jnp.asarray(jax_args[k]) for k in NAMES),
                                            jnp.asarray(dy), jnp.asarray(dh_last))
    y, h_last, grads = _port(arrays, dy, dh_last, reverse, accum)
    np.testing.assert_allclose(y, np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(h_last, np.asarray(h_j), **FWD_TOL)
    for name, g_j in zip(NAMES, grads_j):
        if name == "y_accum" and not accum:
            assert grads[name] is None
            continue
        np.testing.assert_allclose(grads[name], np.asarray(g_j), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("backend", ["chunked", "ref"])
@pytest.mark.parametrize("reverse", [False, True])
def test_two_chained_halves_equal_the_whole(reverse, backend):
    """Two segments, the second seeded with the first's h_last (the first
    in scan order is the right half under ``reverse``), give the whole
    scan's y and h_last, and through autograd its gradients, h0's too."""
    arrays, dy, dh_last = _inputs(L=96)
    y, h_last, grads = _port(arrays, dy, dh_last, reverse, True, backend)

    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    whole = {k: leaves[k] for k in ("u", "delta", "B", "C", "y_accum")}
    half = lambda i: {k: v[..., i * 48:(i + 1) * 48] for k, v in whole.items()}
    common = dict(A=leaves["A"], D=leaves["D"], delta_bias=leaves["delta_bias"],
                  delta_softplus=True, backend=backend, reverse=reverse, return_state=True)
    first, second = (half(1), half(0)) if reverse else (half(0), half(1))
    y1, h1 = selective_scan(**first, h0=leaves["h0"], **common)
    y2, h2 = selective_scan(**second, h0=h1, **common)
    y_chain = torch.cat([y2, y1] if reverse else [y1, y2], dim=-1)
    ((y_chain * torch.tensor(dy)).sum() + (h2 * torch.tensor(dh_last)).sum()).backward()
    np.testing.assert_allclose(y_chain.detach().numpy(), y, **FWD_TOL)
    np.testing.assert_allclose(h2.detach().numpy(), h_last, **FWD_TOL)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), grads[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_wrappers_take_the_plain_segment_api_on_cpu(reverse):
    """On CPU tensors the kernels' wrappers run their plain versions with
    the segment API: the forward's h_last and chunk states (starting from
    h0), the backward's dh0 from dh_last; nothing is launched."""
    arrays, dy, dh_last = _inputs(L=300)
    t = {k: torch.tensor(v) for k, v in arrays.items()}
    ops = {k: t[k] for k in ("u", "delta", "A", "B", "C", "D", "delta_bias")}
    before = (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches)
    y, h_last, hchk = selective_scan_cuda(**ops, delta_softplus=True, reverse=reverse,
                                          h0=t["h0"], return_state=True, chunk_states=True)
    np.testing.assert_array_equal(hchk[:, :, -1 if reverse else 0].numpy(), arrays["h0"])
    grads = selective_scan_bwd_cuda(*ops.values(), torch.tensor(dy), hchk, True, reverse,
                                    dh_last=torch.tensor(dh_last), with_state=True)
    want = selective_scan_bwd_ref(*ops.values(), torch.tensor(dy), True, reverse,
                                  h0=t["h0"], dh_last=torch.tensor(dh_last), with_state=True)
    assert len(grads) == 8
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    _, h_want, g_port = _port(arrays, dy, dh_last, reverse, False)
    np.testing.assert_allclose(h_last.numpy(), h_want, **FWD_TOL)
    np.testing.assert_allclose(grads[7].numpy(), g_port["h0"], **GRAD_TOL)
    assert (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches) == before
