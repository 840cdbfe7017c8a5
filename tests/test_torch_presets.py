"""The port's other three trained presets (``baseline``, ``1mlp``,
``1mlp_g4``) against the JAX package's.

Per preset, the JAX model (``vssg_dim=16``, ``ssm_d_state=4``, chunked scan)
is initialised from ``PRNGKey(1234)`` in a module fixture (one jitted JAX
model a preset); its params come into the port through
``state_dict_from_jax``, whose key set must be JAX's ``to_torch_state_dict``
one, and load with ``strict=True``.  The forward on the 32x32 ``linspace``
input must match JAX at rtol 1e-3 / atol 3e-4, the tolerance of
``tests/test_torch_model.py`` (fp32 summation-order noise).  The 256x256
launch plan of ``1mlp`` is read off the port's model on the meta device.
"""

import jax
import numpy as np
import pytest
import torch

import focalnet_tpu_torch.models.ss2d as ss2d_mod
from focalnet_tpu.models import build_net as jax_build_net
from focalnet_tpu.utils.convert import to_torch_state_dict
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.utils import state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(vssg_dim=16, ssm_d_state=4)
TOL = dict(rtol=1e-3, atol=3e-4)
# state-dict keys at TINY: the flagship's 308, the dual branch twice the
# VSSG part of it, the baseline's 6 stages of one ResBlock (2 convs) each
N_KEYS = {"baseline": 68, "1mlp": 572, "1mlp_g4": 308}


@pytest.fixture(scope="module", params=sorted(N_KEYS))
def jax_preset(request):
    preset = request.param
    model = jax_build_net(preset, scan_backend="chunked", **TINY)
    x = np.linspace(0, 1, 32 * 32 * 3, dtype=np.float32).reshape(1, 32, 32, 3)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(1234)}, x)
    want = [np.asarray(o) for o in jax.jit(model.apply)(params, x)]
    return preset, x, jax.device_get(params), want


def test_preset_matches_jax(jax_preset):
    preset, x, params, want = jax_preset
    sd = state_dict_from_jax(params)
    assert len(sd) == N_KEYS[preset]
    assert set(sd) == set(to_torch_state_dict(params))
    port = build_net(preset, device="cpu", **TINY)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"{preset} output {i}")


def test_1mlp_launch_plan_at_256(monkeypatch):
    """``1mlp`` at full width on a 256x256 image: 96 scan calls, 16 a
    (scale, branch) pair; the patch-4 global branch scans 4096, 1024 and 256
    items, the patch-2 local one 16384, 4096 and 1024; every reversed call
    takes its forward partner's output as ``y_accum``."""
    calls = []
    scan = ss2d_mod.selective_scan

    def record(u, *args, reverse=False, y_accum=None, **kw):
        calls.append((tuple(u.shape), reverse, y_accum is not None))
        return scan(u, *args, reverse=reverse, y_accum=y_accum, **kw)

    monkeypatch.setattr(ss2d_mod, "selective_scan", record)
    model = build_net("1mlp", device="meta")
    with torch.no_grad():
        outs = model(torch.zeros(1, 256, 256, 3, device="meta"))
    assert [tuple(o.shape) for o in outs] == [(1, 64, 64, 3), (1, 128, 128, 3),
                                              (1, 256, 256, 3)]
    assert len(calls) == 96
    assert {shape[:2] for shape, _, _ in calls} == {(1, 192)}
    lengths = [shape[2] for shape, _, _ in calls]
    assert {L: lengths.count(L) for L in set(lengths)} == {16384: 16, 4096: 32, 1024: 32,
                                                           256: 16}
    assert [(rev, acc) for _, rev, acc in calls] == [(False, False), (True, True)] * 48
    # the first stage (Encoder_0, full resolution): the global blocks, then the local ones
    assert lengths[:16] == [4096] * 8 + [16384] * 8
