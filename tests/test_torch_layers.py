"""The conv layers that no preset uses against the JAX package's:
``BasicConv(norm=True)`` with its BatchNorm, ``GhostModule`` and
``pixel_shuffle``, with their weights carried by ``state_dict_from_jax``.

- ``BasicConv(norm=True)`` in training mode for two calls (batch statistics,
  the running mean and the biased running variance moved by momentum 0.9),
  its running statistics after them, then in eval mode (running
  statistics), against flax with a mutable ``batch_stats``: rtol 1e-4 /
  atol 1e-5 (fp32; flax's variance is E[x^2] - E[x]^2, the port's two-pass);
- ``GhostModule`` at ratio 2 and 3 (a channel multiplier), rtol 1e-5 /
  atol 1e-6;
- ``pixel_shuffle``, exactly;
- the conversion: the reference's keys for each, where the JAX converter
  gives other ones (the JAX-side faults of ROADMAP Queue 3).
JAX runs eagerly: these modules are a conv and a norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalnet_tpu.models.layers import BasicConv as JaxBasicConv
from focalnet_tpu.models.layers import GhostModule as JaxGhostModule
from focalnet_tpu.models.layers import pixel_shuffle as jax_pixel_shuffle
from focalnet_tpu.models.ss2d import SS2D as JaxSS2D
from focalnet_tpu.utils.convert import to_torch_state_dict
from focalnet_tpu_torch.models import BasicConv, GhostModule, pixel_shuffle
from focalnet_tpu_torch.utils import state_dict_from_jax

torch.set_num_threads(1)

BN_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _variables(op, x, train=False):
    """``op``'s variables with random values drawn by numpy (shapes from
    ``eval_shape``): weights N(0, 0.3^2), scales near 1, running variances
    in [0.5, 1.5)."""
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: op.init({"params": jax.random.PRNGKey(0)}, x,
                                            **({"train": train} if train else {})))

    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return jnp.asarray(0.5 + rng.uniform(size=leaf.shape), jnp.float32)
        v = 0.3 * rng.standard_normal(leaf.shape) + (1.0 if name == "scale" else 0.0)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_basic_conv_batch_norm_matches_flax():
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((2, 6, 5, 3)) * (i + 1) + i).astype(np.float32)
          for i in range(3)]
    jax_op = JaxBasicConv(8, 3, norm=True)
    variables = _variables(jax_op, xs[0])
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == {"main.0.weight", "main.1.weight", "main.1.bias", "main.1.running_mean",
                       "main.1.running_var", "main.1.num_batches_tracked"}
    op = BasicConv(3, 8, 3, norm=True)
    assert op.main[0].bias is None  # no conv bias under a norm
    op.load_state_dict(sd, strict=True)

    op.train()
    for x in xs[:2]:
        want, state = jax_op.apply(variables, x, train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], **state}
        np.testing.assert_allclose(_nhwc(op(_nchw(x))), np.asarray(want), **BN_TOL)
    stats = state_dict_from_jax({}, variables["batch_stats"])
    for k in ("main.1.running_mean", "main.1.running_var"):
        np.testing.assert_allclose(op.state_dict()[k].numpy(), stats[k].numpy(), **BN_TOL,
                                   err_msg=k)
    op.eval()
    want = jax_op.apply(variables, xs[2], train=False)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(op(_nchw(xs[2]))), np.asarray(want), **BN_TOL)


@pytest.mark.parametrize("ratio", [2, 3])
def test_ghost_module_matches_jax(ratio):
    x = np.random.default_rng(1).standard_normal((1, 5, 6, 4)).astype(np.float32)
    jax_op = JaxGhostModule(7, ratio=ratio)
    params = _variables(jax_op, x)
    sd = state_dict_from_jax(params)
    init_ch = -(-7 // ratio)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "primary_conv.0.weight": (init_ch, 4, 1, 1),
        "cheap_operation.0.weight": (init_ch * (ratio - 1), 1, 3, 3)}
    op = GhostModule(4, 7, ratio=ratio)
    op.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nhwc(op(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jax_op.apply(params, x)), **TOL)


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 2 * 3 * 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(pixel_shuffle(_nchw(x), 3)),
                                  np.asarray(jax_pixel_shuffle(jnp.asarray(x), 3)))


def test_jax_converter_faults_are_repaired():
    """Where the JAX converter departs from the reference (ROADMAP Queue 3,
    a fault on the JAX side), the port's gives the reference's keys and
    torch's layouts: the dwconv3 out-norm kernel, GhostModule's two convs,
    BasicConv's BatchNorm."""
    x = np.zeros((1, 4, 4, 8), np.float32)
    ss2d = _variables(JaxSS2D(8, d_state=2, forward_type="v4dwconv3"), x)
    assert to_torch_state_dict(ss2d)["out_norm.weight"].shape == (3, 3, 1, 16)
    assert state_dict_from_jax(ss2d)["out_norm.weight"].shape == (16, 1, 3, 3)

    ghost = _variables(JaxGhostModule(6), x)
    with pytest.raises(ValueError, match="main.0.weight"):
        to_torch_state_dict(ghost)
    assert set(state_dict_from_jax(ghost)) == {"primary_conv.0.weight",
                                               "cheap_operation.0.weight"}

    bn = _variables(JaxBasicConv(8, 3, norm=True), x)
    assert "BatchNorm_0.weight" in to_torch_state_dict(bn["params"])
    assert "main.1.weight" in state_dict_from_jax(bn["params"])
