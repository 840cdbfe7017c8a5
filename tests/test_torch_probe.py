"""The port's probe slice against the JAX package: the FMA-pass kernel's plain
version against the JAX probe's Pallas kernel (in interpret mode, as the JAX
tests run Pallas off the TPU), the FLOP-count utilities and the
``--flops_report`` parameter count against JAX's, the trace parser on a
synthetic torch.profiler trace, and the probe's CLI on the CPU.

Cheap by design: nothing here jits a JAX model; JAX's parameter count comes
from ``jax.eval_shape`` of ``model.init`` (a trace, no compile).
"""

import contextlib
import functools
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalnet_tpu.configs import PRESETS as JAX_PRESETS
from focalnet_tpu.utils import flops as jax_flops
from focalnet_tpu_torch.benchmarks import vpu_probe
from focalnet_tpu_torch.configs import PRESETS
from focalnet_tpu_torch.main import main as cli_main
from focalnet_tpu_torch.ops.fma_passes import (
    fma_passes,
    fma_passes_cuda,
    fma_passes_ref,
)
from focalnet_tpu_torch.utils import flops, profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX probe's JSON line (benchmarks/vpu_probe.py)
JAX_PROBE_KEYS = {"metric", "scan_fwd_device_ms", "probe_fma_tflops", "pass_equivalents",
                  "cost_model_floor_passes", "ratio_to_arithmetic_floor"}


def _jax_probe_module():
    spec = importlib.util.spec_from_file_location(
        "jax_vpu_probe", os.path.join(REPO, "benchmarks", "vpu_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_loop", [1, 2])
def test_fma_passes_ref_matches_jax_pallas_kernel(n_loop, monkeypatch):
    """P = 8 * n_loop passes: the plain version against the JAX probe's
    kernel, run through ``pallas_call(..., interpret=True)`` (patched in
    this test only); rtol 1e-5 / atol 1e-6 (|acc| ~ 9-17, fp32)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x = np.random.default_rng(0).uniform(size=(1, 1, 16, 256)).astype(np.float32)
    want = np.asarray(_jax_probe_module().make_pass_kernel(n_loop, 8, 128)(jnp.asarray(x)))
    got = fma_passes_ref(torch.from_numpy(x), n_loop).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got).max() > 8 * n_loop  # the passes did accumulate


def test_fma_passes_ref_in_float64_uses_the_fp32_multipliers():
    """The float64 plain version (the exact function the card checks K3
    against) equals a numpy float64 loop over the fp32-rounded multipliers;
    the fp32 plain version, two roundings a pass, stays within
    2 * 2^-24 (P/2 + 1) of it."""
    x = np.random.default_rng(1).uniform(size=(4, 64)).astype(np.float32).astype(np.float64)
    n_loop = 4
    cs = [float(np.float32(1.0 + 1e-6 * (i + 1))) for i in range(8)]
    want = x.copy()
    for _ in range(n_loop):
        for c in cs:
            want = want * c + x
    np.testing.assert_array_equal(fma_passes_ref(torch.from_numpy(x), n_loop).numpy(), want)
    f32 = fma_passes_ref(torch.from_numpy(x).float(), n_loop).double().numpy()
    np.testing.assert_allclose(f32, want, rtol=2 * 2.0 ** -24 * (8 * n_loop / 2 + 1), atol=0)


def test_fma_passes_on_cpu_tensor_is_the_plain_version():
    x = torch.rand(3, 5, generator=torch.Generator().manual_seed(0))
    before = fma_passes_cuda.launches
    torch.testing.assert_close(fma_passes(x, 3), fma_passes_ref(x, 3), rtol=0, atol=0)
    assert fma_passes_cuda.launches == before
    torch.testing.assert_close(fma_passes(x, 0), x, rtol=0, atol=0)


def test_fma_passes_cuda_raises_on_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA device"):
        fma_passes_cuda(torch.zeros(4), 1)


@pytest.mark.parametrize("preset", sorted(JAX_PRESETS))
def test_scan_flops_match_jax(preset):
    # the port's presets are JAX's and MambaIR's denoiser, which has no JAX twin
    assert sorted(PRESETS) == sorted([*JAX_PRESETS, "mambair_dn"])
    for batch in (1, 4):
        for hw in ((256, 256), (250, 310)):
            assert flops.mimounet_scan_flops(PRESETS[preset], hw, batch) == \
                jax_flops.mimounet_scan_flops(JAX_PRESETS[preset], hw, batch)
    for args in ((4, 16384, 192, 16), (1, 1000, 768, 4)):
        for with_D in (False, True):
            for with_Z in (False, True):
                assert flops.scan_flops(*args, with_D=with_D, with_Z=with_Z) == \
                    jax_flops.scan_flops(*args, with_D=with_D, with_Z=with_Z)


def test_model_flops_counts_matmuls():
    a, b = torch.zeros(8, 16, device="meta"), torch.zeros(16, 4, device="meta")
    assert flops.model_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4


@pytest.mark.parametrize("backend", ["auto", "chunked", "ref", "cuda"])
def test_scan_on_meta_forms_only_the_shape(backend):
    """The FLOP count's forward runs on the meta device: the scan forms y's
    shape and dtype on every backend, and counts no FLOPs."""
    from focalnet_tpu_torch.ops import selective_scan

    meta = lambda *s: torch.zeros(*s, device="meta")
    y = flops.model_flops(
        lambda: selective_scan(meta(2, 8, 300), meta(2, 8, 300), meta(8, 4),
                               meta(2, 1, 4, 300), meta(2, 1, 4, 300),
                               out_dtype=torch.bfloat16, backend=backend))
    assert y == 0.0
    y = selective_scan(meta(2, 8, 300), meta(2, 8, 300), meta(8, 4), meta(2, 1, 4, 300),
                       meta(2, 1, 4, 300), out_dtype=torch.bfloat16, backend=backend)
    assert y.shape == (2, 8, 300) and y.dtype == torch.bfloat16 and y.is_meta


def _write_trace(tmp_path):
    """A torch.profiler-format Chrome trace: leaf device events, an
    annotation range over them, host events and a flow event."""
    def ev(cat, name, dur_us):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0,
                "dur": dur_us}

    events = [
        ev("kernel", "void selective_scan_fwd_kernel<float, float>(...)", 1000.0),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(...)", 300.0),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32", 150.0),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 120.0),
        ev("gpu_memset", "Memset (Device)", 80.0),
        # must all be excluded
        ev("gpu_user_annotation", "Optimizer.step#Adam.step", 5320.0),
        ev("user_annotation", "Optimizer.step#Adam.step", 5400.0),
        ev("cpu_op", "aten::mul", 9999.0),
        ev("cuda_runtime", "cudaLaunchKernel", 50.0),
        ev("python_function", "torch/nn/modules/module.py(1751): _call_impl", 77.0),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 1, "ts": 0, "id": 1},
    ]
    with open(tmp_path / "trace_1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)


def test_parse_trace_and_op_mix(tmp_path):
    """parse_trace sums leaf device events only (kernels, memcpy, memset):
    annotation ranges and host events would count time twice or count host
    time; op_mix buckets them under the JAX package's keys."""
    _write_trace(tmp_path)
    r = profiling.parse_trace(str(tmp_path))
    assert abs(r["total_ms"] - 1.65) < 1e-9
    cats = {c for _, _, _, c in r["ops"]}
    assert cats == {"kernel", "gpu_memcpy", "gpu_memset"}
    assert sum(n for _, _, n, _ in r["ops"]) == 5
    mix = profiling.op_mix(str(tmp_path))
    assert set(mix) == {"scan_kernel", "conv", "fusion", "layout", "other", "total"}
    for key, ms in (("scan_kernel", 1.0), ("fusion", 0.3), ("conv", 0.15),
                    ("layout", 0.2), ("other", 0.0), ("total", 1.65)):
        assert abs(mix[key] - ms) < 1e-9, key
    assert profiling.parse_trace(str(tmp_path), min_us=200.0)["total_ms"] == pytest.approx(1.3)


def test_trace_timed_and_device_profile_on_cpu(tmp_path):
    """On the CPU a trace holds no device events: parse_trace counts 0 and
    device_profile reports nothing."""
    x = torch.rand(64, 64)
    with profiling.trace(str(tmp_path)), profiling.annotate("matmul"):
        x @ x
    assert profiling.parse_trace(str(tmp_path)) == {"total_ms": 0.0, "ops": []}
    assert profiling.timed(torch.matmul, x, x, iters=2, warmup=1) > 0
    assert profiling.device_profile(lambda: x @ x, reps=2) is None


def test_flops_report_params_match_jax(tmp_path):
    """``--flops_report`` at full width: the parameter count equals JAX's
    exactly (from a shape trace of ``model.init``; no parameter's shape
    depends on the image size, so a 32x32 input traces faster), and the scan
    term is the cost model's.  As in the JAX CLI the report comes first and
    then ``--mode`` runs: here ``serve`` on a reference checkpoint of the
    full-width model with an empty stdin, which prints READY and ends
    without a forward."""
    from focalnet_tpu.models import build_net as jax_build_net
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.utils import save_checkpoint

    shapes = jax.eval_shape(jax_build_net("1mlp_g2").init,
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    ckpt = str(tmp_path / "Best.pkl")
    save_checkpoint(ckpt, build_net("1mlp_g2", device="cpu").state_dict())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = cli_main(["--flops_report", "--mode", "serve", "--test_model", ckpt,
                           "--result_dir", str(tmp_path / "out"), "--device", "cpu",
                           "--model_save_dir", str(tmp_path / "w")],
                          inp=io.StringIO(""))
    assert report["params"] == want
    scan = jax_flops.mimounet_scan_flops(JAX_PRESETS["1mlp_g2"], (256, 256))
    assert report["scan_flops"] == scan
    assert report["counted_flops"] > 0
    out = buf.getvalue().splitlines()
    assert out[2:] == ["READY"]  # the report, then the mode
    lines = out[:2]
    assert lines == [
        f"params: {want / 1e6:.3f}M",
        f"counted flops @256^2: {report['counted_flops'] / 1e9:.2f} GFLOPs"
        f" + scan {scan / 1e9:.2f} GFLOPs (9BLDN model)"
        f" = {(report['counted_flops'] + scan) / 1e9:.2f} GFLOPs total",
    ]


def test_vpu_probe_cli_on_cpu():
    """The probe's CLI at a tiny shape on the CPU: the JAX probe's JSON keys,
    the cost-model floor 9N/2, and no device number."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = vpu_probe.main(["--device", "cpu", "--B", "1", "--D", "8", "--L", "256",
                            "--N", "4"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("device: cpu")
    out = json.loads(lines[-1])
    assert set(out) == JAX_PROBE_KEYS
    assert out["metric"] == "scan_vpu_ceiling"
    assert out["cost_model_floor_passes"] == 9 * 4 / 2
    assert out["scan_fwd_device_ms"] is None and out["probe_fma_tflops"] is None
    assert r["passes"] == [64, 512] and r["device"] == "cpu"
