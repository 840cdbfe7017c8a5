"""The port's bf16 recipe (``compute_dtype="bfloat16"``,
``ssm_out_dtype="bfloat16"``), ``ssm_proj_dtype`` and ``use_checkpoint``
against the JAX package's.

One jitted JAX model: the tiny ``1mlp_g2`` (``vssg_dim=16``,
``ssm_d_state=4``, chunked scan) under the recipe, as in
``tests/test_bf16.py``, initialised from ``PRNGKey(1234)`` on the 32x32
``linspace`` input.  Its forward is compiled with XLA's
``xla_allow_excess_precision`` off: by default XLA's CPU compiler skips a
bf16 rounding wherever the value is converted straight back to fp32 (a conv
feeding a norm, inside a fused activation), so its rounding points depend on
its fusions; without that it rounds at every point the JAX program names.
Its fp32 counterpart's outputs are ``tests/golden/tiny_golden.npz`` (the
same model, params and input in fp32; ``tests/test_torch_model.py`` holds
the port to them).  The port under the recipe rounds where the JAX program
rounds: max |port - JAX bf16| found 0.0078 per output (one bf16 step below
2), against max |JAX bf16 - JAX fp32| of 0.058, 0.061 and 0.015.
"""

import os

import jax
import numpy as np
import pytest
import torch

from focalnet_tpu.models import build_net as jax_build_net
from focalnet_tpu_torch.models import SS2D, build_net, set_dropout_generator
from focalnet_tpu_torch.train.losses import multiscale_loss
from focalnet_tpu_torch.train.trainer import step_seed
from focalnet_tpu_torch.utils import state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(vssg_dim=16, ssm_d_state=4)
RECIPE = dict(compute_dtype="bfloat16", ssm_out_dtype="bfloat16")
BF16_ATOL = 0.15  # tests/test_bf16.py: bf16 against fp32, per element
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_golden.npz")


def _x():
    return np.linspace(0, 1, 32 * 32 * 3, dtype=np.float32).reshape(1, 32, 32, 3)


@pytest.fixture(scope="module")
def jax_bf16():
    model = jax_build_net("1mlp_g2", scan_backend="chunked", **TINY, **RECIPE)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(1234)}, _x())
    outs = jax.jit(model.apply).lower(params, _x()).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, _x())
    return state_dict_from_jax(jax.device_get(params)), [np.asarray(o) for o in outs]


def _port(sd, **kw):
    model = build_net("1mlp_g2", device="cpu", **TINY, **kw)
    model.load_state_dict(sd, strict=True)
    return model


def _loss_and_grads(model, seed_step=None):
    """The train loss of the linspace input against a clipped 1.1x target, and
    every parameter's gradient; with ``seed_step`` in train mode, DropPath
    drawing from that step's generator (returned too)."""
    x = torch.from_numpy(_x())
    gen = None
    if seed_step is not None:
        gen = torch.Generator().manual_seed(step_seed(*seed_step))
        set_dropout_generator(model.train(), gen)
    model.zero_grad(set_to_none=True)
    loss = multiscale_loss(model(x), torch.clamp(x * 1.1, 0, 1))[0]
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}, gen


def test_recipe_rounds_where_jax_rounds(jax_bf16):
    """Outputs fp32, within bf16 tolerance of the port's fp32 outputs, and
    nearer to JAX's bf16 outputs than JAX's bf16 outputs are to its fp32 ones."""
    sd, want_bf16 = jax_bf16
    golden = np.load(GOLDEN)
    with torch.no_grad():
        got = _port(sd, **RECIPE)(torch.from_numpy(_x()))
        fp32 = _port(sd)(torch.from_numpy(_x()))
    for i, (g, f, w) in enumerate(zip(got, fp32, want_bf16)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), f.numpy(), atol=BF16_ATOL)
        to_jax_bf16 = np.abs(g.numpy() - w).max()
        jax_split = np.abs(w - golden[f"out{i}"]).max()
        assert to_jax_bf16 < jax_split, (i, to_jax_bf16, jax_split)


def test_recipe_params_and_grads_fp32(jax_bf16):
    sd, _ = jax_bf16
    model = _port(sd, **RECIPE)
    loss, grads, _ = _loss_and_grads(model)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert len(grads) == 308
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        assert grads[k].dtype == torch.float32 and bool(torch.isfinite(grads[k]).all()), k


def test_proj_dtype_rounds_only_the_projections(jax_bf16):
    """``ssm_proj_dtype="bfloat16"`` under the recipe is the recipe with the
    x_proj and dt_proj weights rounded to bf16 (the activations are bf16
    already), bitwise; and it changes the outputs."""
    sd, _ = jax_bf16
    rounded = {k: v.to(torch.bfloat16).float()
               if k.endswith(("x_proj_weight", "dt_projs_weight")) else v
               for k, v in sd.items()}
    x = torch.from_numpy(_x())
    with torch.no_grad():
        got = _port(sd, ssm_proj_dtype="bfloat16", **RECIPE)(x)
        want = _port(rounded, **RECIPE)(x)
        plain = _port(sd, **RECIPE)(x)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
    assert not all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_replays_drop_path_masks(dtype):
    """``use_checkpoint=True`` in train mode at drop_path_rate 0.1: the same
    loss and gradients, bitwise, as without it, and the step's generator
    left in the same state (the recomputation draws the forward's masks)."""
    kw = dict(compute_dtype=dtype, ssm_out_dtype=dtype, drop_path_rate=0.1)
    runs, ss2d_calls = [], []
    for use_checkpoint in (False, True):
        model = build_net("1mlp_g2", device="cpu", use_checkpoint=use_checkpoint,
                          generator=torch.Generator().manual_seed(1234), **TINY, **kw)
        calls = []
        for m in model.modules():
            if isinstance(m, SS2D):
                m.register_forward_hook(lambda *_: calls.append(1))
        runs.append(_loss_and_grads(model, seed_step=(1234, 7)))
        ss2d_calls.append(len(calls))
    assert ss2d_calls == [12, 24]  # the backward recomputed every block
    (loss, grads, gen), (loss_c, grads_c, gen_c) = runs
    untouched = torch.Generator().manual_seed(step_seed(1234, 7)).get_state()
    assert not torch.equal(gen.get_state(), untouched)  # masks were drawn
    assert torch.equal(gen_c.get_state(), gen.get_state())
    assert torch.equal(loss_c, loss)
    for k, g in grads.items():
        assert torch.equal(grads_c[k], g), k
