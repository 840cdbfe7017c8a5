"""Every SS2D variant of the port against the JAX package's.

- ``parse_forward_type`` of both packages over every tag the grammar makes
  (five base tags, five out-norms, the z suffixes, ``no32``);
- one SS2D a variant (``d_model`` 16, N = 4, an 8x8 input): the JAX module
  on ``scan_backend="ref"`` with random params drawn by numpy, carried by
  ``state_dict_from_jax`` (the dwconv3 kernel too), the port on its CPU
  path; output and every parameter's gradient of ``sum(y * w)``, one jitted
  ``value_and_grad`` a variant.  fp32 at the model tests' tolerance (rtol
  1e-3, atol 3e-4; gradients 1e-3 of the largest, as the sequence-parallel
  tests).  bf16 (``force_fp32`` under bf16 activations, compiled with XLA's
  excess precision off as in ``tests/test_torch_bf16.py``) as
  ``tests/test_torch_bf16.py`` holds the model: the port nearer to JAX's
  bf16 result than JAX's bf16 result is to the fp32 one (the port's fp32
  result, which the fp32 cases hold to JAX's), and the gradients within
  ``BF16_GRAD_TOL`` of JAX's bf16 ones;
- the v1 and v2 init laws, the port's draws against flax's initializers.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from focalnet_tpu.models.ss2d import SS2D as JaxSS2D
from focalnet_tpu.models.ss2d import parse_forward_type as jax_parse
from focalnet_tpu_torch.models import SS2D, parse_forward_type
from focalnet_tpu_torch.models.initializers import init_weights
from focalnet_tpu_torch.utils import state_dict_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=3e-4)
GRAD_RTOL = 1e-3  # of the largest gradient
# bf16 gradients, per parameter: max |got - want| <= 0.1 max |want| + 0.02 G,
# G the largest gradient (chip_smoke.py's BF16_GRAD_TOL): the bf16 weight
# products' backward sums round in another order than XLA's (found: 4 of 318,
# a few bf16 steps, in in_proj and conv2d; the outputs are equal bit for bit)
BF16_GRAD_TOL = (0.1, 0.02)
KW = dict(d_model=16, d_state=4)
BASES = ("v01", "v1", "v2", "v3", "v4")
NORMS = ("", "none", "dwconv3", "softmax", "sigmoid")
ZS = ("", "noz", "nozact", "nozactnoz")

# (forward_type, initialize, d_conv, bf16): every out-norm, noz and nozact,
# force_fp32 in fp32 and under bf16 activations, v1 / v2 init, d_conv = 1
VARIANTS = [
    ("v4none", "v0", 3, False),
    ("v4dwconv3", "v2", 3, False),
    ("v4softmaxnoz", "v1", 1, False),
    ("v2sigmoidnoz", "v0", 3, False),
    ("v4nozact", "v0", 3, False),
    ("v01no32", "v0", 1, False),
    ("v1", "v1", 1, True),
    ("v2dwconv3nozact", "v2", 3, True),
]


def test_parse_forward_type_matches_jax():
    tags = ["".join(p) for p in itertools.product(BASES, NORMS, ZS, ("", "no32"))]
    for tag in tags:
        assert parse_forward_type(tag) == jax_parse(tag), tag


def _x(bf16):
    x = np.random.default_rng(3).standard_normal((1, 8, 8, 16)).astype(np.float32)
    return x.astype(jnp.bfloat16) if bf16 else x


def _weights():
    return np.random.default_rng(4).standard_normal((1, 8, 8, 16)).astype(np.float32)


def _params(op, x):
    """Random params of ``op`` in its tree (shapes from ``eval_shape``: no
    compiled init), drawn with numpy: weights N(0, 0.3^2), norm scales and
    D near 1, A_log near log(1..N)."""
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(op.init, {"params": jax.random.PRNGKey(0)}, x)

    def draw(path, leaf):
        name = path[-1].key
        v = 0.3 * rng.standard_normal(leaf.shape)
        if name == "A_logs":
            v += np.log(np.arange(1, leaf.shape[-1] + 1))
        elif name in ("scale", "Ds"):
            v += 1.0
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_value_and_grads(forward_type, d_conv, bf16):
    """JAX's output and parameter gradients of ``sum(y * w)``, and its params."""
    op = JaxSS2D(**KW, d_conv=d_conv, forward_type=forward_type, scan_backend="ref",
                 dtype=jnp.bfloat16 if bf16 else None)
    x, w = _x(bf16), _weights()
    params = _params(op, x)

    def loss(p):
        y = op.apply(p, x)
        return jnp.sum(y.astype(jnp.float32) * w), y

    compiled = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False} if bf16 else None)
    (_, y), grads = compiled(params)
    return np.asarray(y.astype(jnp.float32)), state_dict_from_jax(jax.device_get(grads)), params


def _port_value_and_grads(sd, forward_type, initialize, d_conv, bf16):
    op = SS2D(**KW, d_conv=d_conv, forward_type=forward_type, initialize=initialize)
    op.load_state_dict(sd, strict=True)
    x = torch.from_numpy(_x(False))
    y = op(x.bfloat16() if bf16 else x)
    (y.float() * torch.from_numpy(_weights())).sum().backward()
    return y.detach().float().numpy(), {k: p.grad.numpy() for k, p in op.named_parameters()}


@pytest.mark.parametrize("forward_type,initialize,d_conv,bf16", VARIANTS)
def test_variant_matches_jax(forward_type, initialize, d_conv, bf16):
    y_j, grads_j, params = _jax_value_and_grads(forward_type, d_conv, bf16)
    sd = state_dict_from_jax(jax.device_get(params))
    flags = parse_forward_type(forward_type)
    assert ("conv2d.weight" in sd) == (d_conv > 1)
    assert sd["in_proj.weight"].shape[0] == (32 if flags["disable_z"] else 64)
    if flags["out_norm"] == "dwconv3":
        assert sd["out_norm.weight"].shape == (32, 1, 3, 3)
    y, grads = _port_value_and_grads(sd, forward_type, initialize, d_conv, bf16)
    assert set(grads) == set(grads_j) == set(sd)
    if not bf16:
        np.testing.assert_allclose(y, y_j, **TOL)
        scale = max(float(g.abs().max()) for g in grads_j.values())
        for k, g in grads_j.items():
            np.testing.assert_allclose(grads[k], g.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * scale, err_msg=k)
        return
    y32, _ = _port_value_and_grads(sd, forward_type, initialize, d_conv, False)
    assert np.abs(y - y_j).max() < np.abs(y_j - y32).max()
    scale = max(float(g.abs().max()) for g in grads_j.values())
    rel, ab = BF16_GRAD_TOL
    for k, g in grads_j.items():
        g = g.numpy()
        assert np.abs(grads[k] - g).max() <= rel * np.abs(g).max() + ab * scale, k


@pytest.mark.parametrize("initialize", ["v1", "v2"])
def test_init_laws_match_flax(initialize):
    """The raw stacks' laws: v1 normal(1) for the dt weights, dt bias and
    A_log; v2 flax's uniform(0.1), U[0, 0.1), for the dt weights and bias and
    A_log zero; D = 1 and x_proj U(+-1/sqrt(d_inner)) in both.  The port's
    draws (d_inner 256) against flax's of the same shapes: mean, standard
    deviation and range."""
    op = SS2D(128, d_state=16, initialize=initialize)
    init_weights(op, torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    law = fnn.initializers.normal(1.0) if initialize == "v1" else fnn.initializers.uniform(0.1)
    names = ("dt_projs_weight", "dt_projs_bias") + (("A_logs",) if initialize == "v1" else ())
    for name in names:
        got = getattr(op, name).detach().numpy()
        want = np.asarray(law(jax.random.fold_in(key, len(name)), got.shape))
        assert abs(got.mean() - want.mean()) < 5 * want.std() / np.sqrt(got.size), name
        assert abs(got.std() / want.std() - 1) < 0.05, name
        if initialize == "v2":
            assert got.min() >= 0 and got.max() < 0.1, name
    if initialize == "v2":
        assert not op.A_logs.detach().any()
    assert torch.equal(op.Ds.detach(), torch.ones_like(op.Ds))
    assert op.x_proj_weight.abs().max() <= 1 / np.sqrt(op.d_inner)
