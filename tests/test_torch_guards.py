"""Guards of the port: no JAX inside it, no silent CPU fallback, and the CUDA
kernels' contract (the kernels run only on the card: those tests skip on a
machine without one)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import focalnet_tpu_torch.utils.device as device_mod
from focalnet_tpu_torch.benchmarks import vpu_probe
from focalnet_tpu_torch.evaluation import serve
from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.ops import selective_scan
from focalnet_tpu_torch.ops.fma_passes import fma_passes_cuda, fma_passes_ref
from focalnet_tpu_torch.ops.scan_bwd_ref import chunk_states_ref, selective_scan_bwd_ref
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    bwd_tile_channels,
    fwd_launched_tile,
    fwd_tile_channels,
    selective_scan_bwd_cuda,
    selective_scan_cuda,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vssg_dim=16, ssm_d_state=4)


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) in a fresh
    interpreter leaves jax, flax and focalnet_tpu out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, focalnet_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(focalnet_tpu_torch.__path__, 'focalnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'focalnet_tpu'))\n"
        "for m in ('main', 'train.trainer', 'train.checkpoint', 'data.reside',\n"
        "          'evaluation.evaluator', 'ops.scan_bwd_ref', 'ops.fma_passes',\n"
        "          'benchmarks.vpu_probe', 'utils.flops', 'utils.profiling',\n"
        "          'parallel', 'parallel.mesh', 'parallel.seq_scan', 'parallel.tp_scan'):\n"
        "    assert 'focalnet_tpu_torch.' + m in sys.modules, m\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_net("1mlp_g2", **TINY)
    model = build_net("1mlp_g2", device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(model, str(tmp_path), inp=io.StringIO(""), out=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "serve", "--test_model", "unused.pkl"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "train", "--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--flops_report"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vpu_probe.main([])


def _scan_inputs(device, L=300, dim=8, N=4, G=2, batch=2):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(
        u=r(batch, dim, L) * 0.5, delta=torch.rand(batch, dim, L, generator=g) * 0.5,
        A=-0.5 - 2 * torch.rand(dim, N, generator=g), B=r(batch, G, N, L) * 0.5,
        C=r(batch, G, N, L) * 0.5, D=r(dim), delta_bias=0.3 * r(dim),
    )
    return {k: v.to(device) for k, v in t.items()}, r(batch, dim, L).to(device)


def test_cuda_backend_raises_on_cpu_tensors():
    x, _ = _scan_inputs("cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        selective_scan(**x, delta_softplus=True, backend="cuda")


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_wrapper_takes_plain_scan_for_cpu_tensors(reverse):
    x, yacc = _scan_inputs("cpu")
    before = selective_scan_cuda.launches
    got = selective_scan_cuda(**x, delta_softplus=True, reverse=reverse, y_accum=yacc)
    want = selective_scan(**x, delta_softplus=True, backend="ref",
                          reverse=reverse, y_accum=yacc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=6e-4, atol=2e-3)
    assert selective_scan_cuda.launches == before  # nothing was launched


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain_on_card(reverse, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, yacc = _scan_inputs("cuda", L=1000, dim=16, N=16, G=1)
    yacc = yacc.to(out_dtype)
    before = selective_scan_cuda.launches
    with torch.no_grad():
        got = selective_scan(**x, delta_softplus=True, backend="cuda",
                             reverse=reverse, y_accum=yacc, out_dtype=out_dtype)
        want = selective_scan(**x, delta_softplus=True, backend="chunked",
                              reverse=reverse, y_accum=yacc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == before + 1
    tol = dict(rtol=6e-4, atol=2e-3) if out_dtype == torch.float32 else dict(rtol=3e-2, atol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,G,N,L,reverse,in_dtype,out_dtype,tile", [
    (192, 1, 16, 1024, False, torch.float32, torch.float32, None),  # the model's width
    (12, 2, 16, 1000, True, torch.float32, torch.float32, 6),       # 6 channels a group
    (16, 2, 16, 1000, False, torch.float32, torch.float32, 4),      # 8 a group
    (18, 2, 16, 1000, True, torch.float32, torch.float32, 3),       # 9 a group
    (20, 2, 16, 1000, False, torch.float32, torch.float32, 2),      # 10 a group
    (10, 2, 16, 1000, True, torch.float32, torch.float32, 1),       # 5 a group
    (16, 1, 4, 1000, True, torch.float32, torch.float32, None),     # N = 4
    (16, 2, 16, 1000, False, torch.bfloat16, torch.bfloat16, 4),    # bf16 in and out
    (24, 4, 16, 999, True, torch.bfloat16, torch.float32, 6),       # L % 8 != 0: plain loads
    (24, 4, 16, 999, False, torch.float32, torch.bfloat16, 6),
    (384, 1, 16, 1024, False, torch.float32, torch.float32, None),  # Mamba1D's one group
    (384, 1, 16, 1024, True, torch.float32, torch.float32, None),
    # force_fp32 under the bf16 recipe: fp32 operands, bf16 y_accum and out
    (192, 1, 16, 1024, True, torch.float32, torch.bfloat16, None),
])
def test_forward_kernel_tiles_match_plain_on_card(dim, G, N, L, reverse, in_dtype, out_dtype,
                                                  tile):
    """K1 alone, with y_accum and chunk states, against the plain scan and
    chunk_states_ref, at widths that take each tile of channels, both
    directions, bf16 in and out and a ragged L; the launch takes the tile
    that fwd_tile_channels reports.  A tile of T channels is taken when T
    divides a group's channels and the batch fills the card's SMs with one
    block each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    batch = 2
    if tile is not None:
        batch = torch.cuda.get_device_properties(0).multi_processor_count * tile // dim
        assert fwd_tile_channels(batch, dim, G, N, in_dtype, out_dtype) == tile
    x, yacc = _scan_inputs("cuda", L=L, dim=dim, N=N, G=G, batch=batch)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(in_dtype)
    kw = dict(delta_softplus=True, reverse=reverse, y_accum=yacc.to(out_dtype),
              out_dtype=out_dtype)
    with torch.no_grad():
        before = selective_scan_cuda.launches
        got, hchk = selective_scan_cuda(**x, chunk_states=True, **kw)
        torch.cuda.synchronize()
        assert selective_scan_cuda.launches == before + 1
        assert fwd_launched_tile() == fwd_tile_channels(batch, dim, G, N, in_dtype, out_dtype)
        want = selective_scan(**x, backend="chunked", **kw)
        want_h = chunk_states_ref(x["u"], x["delta"], x["A"], x["B"], x["delta_bias"], True,
                                  reverse)
    tol = dict(rtol=6e-4, atol=2e-3) if out_dtype == torch.float32 else dict(rtol=3e-2, atol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(hchk, want_h, rtol=6e-4, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("L", [76800, 4800])
def test_forward_kernel_at_eval_lengths_on_card(L, batch):
    """K1 at the model's widths and two scan lengths of a 480x640 forward
    (SOTS-indoor's 460x620, padded): 76800, and 4800, which is not a
    multiple of the 256-item chunk.  Forward, and reverse with y_accum,
    against the plain scan; the launch takes the tile fwd_tile_channels
    reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, yacc = _scan_inputs("cuda", L=L, dim=192, N=16, G=1, batch=batch)
    for reverse, acc in ((False, None), (True, yacc)):
        kw = dict(delta_softplus=True, reverse=reverse, y_accum=acc)
        with torch.no_grad():
            before = selective_scan_cuda.launches
            got = selective_scan_cuda(**x, **kw)
            torch.cuda.synchronize()
            assert selective_scan_cuda.launches == before + 1
            assert fwd_launched_tile() == fwd_tile_channels(batch, 192, 1, 16)
            want = selective_scan(**x, backend="chunked", **kw)
        torch.testing.assert_close(got, want, rtol=6e-4, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,L,dtype", [
    (1, 256, torch.float32),      # the patch-4 branch at 256x256: one 256-item chunk
    (4, 256, torch.float32),      # the train step's batch
    (1, 1200, torch.float32),     # at 480x640: four chunks and a ragged 176
    (4, 256, torch.bfloat16),     # the bf16 recipe: bf16 in, out and y_accum
])
def test_forward_kernel_at_preset_lengths_on_card(batch, L, dtype):
    """K1 at the model's widths and the other presets' new scan lengths,
    forward, and reverse with y_accum, with chunk states, against the plain
    scan and chunk_states_ref.  In bf16 the kernel adds y_accum before its
    rounding and the plain scan after it: one bf16 step apart at most."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, yacc = _scan_inputs("cuda", L=L, dim=192, N=16, G=1, batch=batch)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(dtype)
    tol = dict(rtol=6e-4, atol=2e-3) if dtype == torch.float32 else dict(rtol=3e-2, atol=5e-2)
    for reverse, acc in ((False, None), (True, yacc.to(dtype))):
        kw = dict(delta_softplus=True, reverse=reverse, y_accum=acc, out_dtype=dtype)
        with torch.no_grad():
            before = selective_scan_cuda.launches
            got, hchk = selective_scan_cuda(**x, chunk_states=True, **kw)
            torch.cuda.synchronize()
            assert selective_scan_cuda.launches == before + 1
            assert fwd_launched_tile() == fwd_tile_channels(batch, 192, 1, 16, dtype, dtype)
            want = selective_scan(**x, backend="chunked", **kw)
            want_h = chunk_states_ref(x["u"], x["delta"], x["A"], x["B"], x["delta_bias"],
                                      True, reverse)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)
        torch.testing.assert_close(hchk, want_h, rtol=6e-4, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_kernel_at_length_256_on_card(reverse, dtype):
    """K2 at the model's widths, L = 256 (one chunk, walked backwards from
    K1's one chunk state), the train step's batch of 4, against the plain
    adjoint; in bf16 with a bf16 dy, as the recipe's scans give it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, dy = _scan_inputs("cuda", L=256, dim=192, N=16, G=1, batch=4)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(dtype)
    dy = dy.to(dtype)
    with torch.no_grad():
        _, hchk = selective_scan_cuda(**x, delta_softplus=True, reverse=reverse,
                                      chunk_states=True)
        before = selective_scan_bwd_cuda.launches
        got = selective_scan_bwd_cuda(*x.values(), dy, hchk, True, reverse)
        torch.cuda.synchronize()
        assert selective_scan_bwd_cuda.launches == before + 1
        want = selective_scan_bwd_ref(*x.values(), dy, True, reverse)
    for g, w in zip(got, want):
        scale = max(w.float().abs().max().item(), 1.0)
        tol = 1e-3 if dtype == torch.float32 else 2e-2  # bf16: du, ddelta rounded
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_kernel_matches_plain_on_card(reverse, in_dtype):
    """The kernel pair through autograd (K1 with chunk states, then K2)
    against the plain adjoint, with y_accum; one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, dy = _scan_inputs("cuda", L=1000, dim=16, N=16, G=1)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(in_dtype)
    leaves = {k: v.clone().requires_grad_() for k, v in x.items()}
    yacc = torch.randn_like(dy).requires_grad_()
    before = (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches)
    y = selective_scan(**leaves, delta_softplus=True, backend="cuda",
                       reverse=reverse, y_accum=yacc)
    got = torch.autograd.grad(y, [*leaves.values(), yacc], dy)
    torch.cuda.synchronize()
    assert (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want = selective_scan_bwd_ref(*x.values(), dy, True, reverse)
    assert torch.equal(got[7], dy)
    for g, w in zip(got[:7], want):
        assert g.dtype == w.dtype or g.dtype == in_dtype
        scale = max(w.float().abs().max().item(), 1.0)
        tol = 1e-3 if in_dtype == torch.float32 else 2e-2  # bf16: du, ddelta rounded
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_pair_with_accum_at_tp_shard_on_card(reverse, in_dtype):
    """K1 with y_accum at two B/C groups, the channel-split scan's shard of a
    stacked pair (2 x 96 channels, batch 4; L = 1024 for 16384), then K2
    through autograd, one launch each: y and every gradient against the
    plain scan and its plain adjoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, dy = _scan_inputs("cuda", L=1024, dim=192, N=16, G=2, batch=4)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(in_dtype)
    leaves = {k: v.clone().requires_grad_() for k, v in x.items()}
    yacc = torch.randn_like(dy).requires_grad_()
    before = (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches)
    y = selective_scan(**leaves, delta_softplus=True, backend="cuda", reverse=reverse,
                       y_accum=yacc)
    got = torch.autograd.grad(y, [*leaves.values(), yacc], dy)
    torch.cuda.synchronize()
    assert (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        y_want = selective_scan(**x, delta_softplus=True, backend="chunked", reverse=reverse,
                                y_accum=yacc)
    rtol, atol = (6e-4, 2e-3) if in_dtype == torch.float32 else (3e-2, 5e-2)
    assert ((y - y_want).abs() <= atol + rtol * y_want.abs()).all()
    want = selective_scan_bwd_ref(*x.values(), dy, True, reverse)
    assert torch.equal(got[7], dy)
    for g, w in zip(got[:7], want):
        scale = max(w.float().abs().max().item(), 1.0)
        tol = 1e-3 if in_dtype == torch.float32 else 2e-2  # bf16: du, ddelta rounded
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dim,G,L,reverse,accum,in_dtype", [
    (384, 2, 1000, False, False, torch.float32),  # the sequence-parallel width, ragged L
    (384, 2, 1024, True, True, torch.float32),
    (16, 2, 999, True, False, torch.bfloat16),    # L % 8 != 0: plain loads
    (24, 2, 1000, False, True, torch.bfloat16),
])
def test_segment_kernels_match_plain_on_card(dim, G, L, reverse, accum, in_dtype):
    """The segment API on the card: K1 with h0 -> h_last (and its chunk
    states from h0) and K2 with dh_last -> dh0, one launch each, against the
    plain versions; two chained half segments against the whole launch; a
    zero h0 and dh_last give the plain launch's y, chunk states, du and
    ddelta bit for bit (dA, dB, dC, dD and dbias are summed by atomics in no
    fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, dy = _scan_inputs("cuda", L=L, dim=dim, N=16, G=G)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(in_dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    h0, dh_last = (torch.randn(2, dim, 16, device="cuda", generator=g) for _ in range(2))
    kw = dict(delta_softplus=True, reverse=reverse,
              y_accum=torch.randn_like(dy) if accum else None)
    before = (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches)
    y, h_last, hchk = selective_scan_cuda(**x, **kw, h0=h0, return_state=True,
                                          chunk_states=True)
    grads = selective_scan_bwd_cuda(*x.values(), dy, hchk, True, reverse, dh_last=dh_last,
                                    with_state=True)
    torch.cuda.synchronize()
    assert (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    y_w, h_w = selective_scan(**x, **kw, backend="chunked", h0=h0, return_state=True)
    tol = dict(rtol=6e-4, atol=2e-3) if in_dtype == torch.float32 else dict(rtol=3e-2, atol=5e-2)
    torch.testing.assert_close(y, y_w, **tol)
    torch.testing.assert_close(h_last, h_w, **tol)
    torch.testing.assert_close(hchk, chunk_states_ref(x["u"], x["delta"], x["A"], x["B"],
                                                      x["delta_bias"], True, reverse, h0=h0),
                               **tol)
    want = selective_scan_bwd_ref(*x.values(), dy, True, reverse, h0=h0, dh_last=dh_last,
                                  with_state=True)
    assert len(grads) == len(want) == 8
    for got, w in zip(grads, want):
        scale = max(w.float().abs().max().item(), 1.0)
        gtol = 1e-3 if in_dtype == torch.float32 else 2e-2  # bf16: du, ddelta rounded
        assert (got.float() - w.float()).abs().max().item() <= gtol * scale

    m = L // 2  # two chained segments, the first in scan order seeded with h0
    half = lambda t, i: (t[..., :m] if i == 0 else t[..., m:]).contiguous()
    seg = lambda i, h: selective_scan_cuda(
        **{k: half(v, i) if k in ("u", "delta", "B", "C") else v for k, v in x.items()},
        delta_softplus=True, reverse=reverse,
        y_accum=None if kw["y_accum"] is None else half(kw["y_accum"], i),
        h0=h, return_state=True)
    first, second = (1, 0) if reverse else (0, 1)
    y1, h1 = seg(first, h0)
    y2, h2 = seg(second, h1)
    torch.testing.assert_close(torch.cat([y2, y1] if reverse else [y1, y2], dim=-1), y, **tol)
    torch.testing.assert_close(h2, h_last, **tol)

    zero = torch.zeros_like(h0)
    y_null, hchk_null = selective_scan_cuda(**x, **kw, chunk_states=True)
    y_zero, _, hchk_zero = selective_scan_cuda(**x, **kw, h0=zero, return_state=True,
                                               chunk_states=True)
    assert torch.equal(y_zero, y_null) and torch.equal(hchk_zero, hchk_null)
    g_null = selective_scan_bwd_cuda(*x.values(), dy, hchk_null, True, reverse)
    g_zero = selective_scan_bwd_cuda(*x.values(), dy, hchk_null, True, reverse,
                                     dh_last=zero, with_state=True)
    assert torch.equal(g_zero[0], g_null[0]) and torch.equal(g_zero[1], g_null[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dim,G,N,L,reverse,in_dtype,tile", [
    (192, 2, 16, 1024, False, torch.float32, 6),   # two groups of 96 channels
    (12, 2, 16, 1000, True, torch.float32, 6),     # 6 channels a group
    (16, 2, 16, 1000, False, torch.float32, 4),    # 8 a group
    (18, 2, 16, 1000, True, torch.float32, 3),     # 9 a group
    (20, 2, 16, 1000, False, torch.float32, 2),    # 10 a group
    (10, 2, 16, 1000, True, torch.float32, 1),     # 5 a group
    (16, 1, 4, 1000, True, torch.float32, None),   # N = 4
    (16, 2, 16, 1000, True, torch.bfloat16, 4),    # bf16 in
    (24, 4, 16, 999, False, torch.bfloat16, 6),    # L % 8 != 0: the scalar loads and atomics
    (384, 1, 16, 1024, False, torch.float32, None),  # Mamba1D's one group of 384 channels
    (384, 1, 16, 1024, True, torch.float32, None),
])
def test_backward_kernel_tiles_match_plain_on_card(dim, G, N, L, reverse, in_dtype, tile):
    """K2 alone (K1's chunk states, then one K2 launch) against the plain
    adjoint, at widths that take each tile of channels, with a ragged L.  A
    tile of T channels is taken when T divides a group's channels and the
    batch fills the card's SMs with one block each (one wave of T-channel
    blocks walks no more channels per SM than any smaller tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    batch = 2
    if tile is not None:
        batch = torch.cuda.get_device_properties(0).multi_processor_count * tile // dim
        assert bwd_tile_channels(batch, dim, G, N, in_dtype) == tile
    x, dy = _scan_inputs("cuda", L=L, dim=dim, N=N, G=G, batch=batch)
    for k in ("u", "delta", "B", "C"):
        x[k] = x[k].to(in_dtype)
    with torch.no_grad():
        _, hchk = selective_scan_cuda(**x, delta_softplus=True, reverse=reverse,
                                      chunk_states=True)
        before = selective_scan_bwd_cuda.launches
        got = selective_scan_bwd_cuda(*x.values(), dy, hchk, True, reverse)
        torch.cuda.synchronize()
        assert selective_scan_bwd_cuda.launches == before + 1
        want = selective_scan_bwd_ref(*x.values(), dy, True, reverse)
    for g, w in zip(got, want):
        scale = max(w.float().abs().max().item(), 1.0)
        tol = 1e-3 if in_dtype == torch.float32 else 2e-2  # bf16: du, ddelta rounded
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_kernels_take_n16_after_n4_on_card():
    """K1 and K2 at N = 16, then N = 4, then N = 16 again on the same widths
    (the same tile) against their plain versions: the first use at a
    smaller N must not leave the kernels too little shared memory for the
    larger one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for N in (16, 4, 16):
        x, dy = _scan_inputs("cuda", L=1000, dim=16, N=N, G=1)
        with torch.no_grad():
            y, hchk = selective_scan_cuda(**x, delta_softplus=True, chunk_states=True)
            got = selective_scan_bwd_cuda(*x.values(), dy, hchk, True, False)
            torch.cuda.synchronize()
            want_y = selective_scan(**x, delta_softplus=True, backend="chunked")
            want = selective_scan_bwd_ref(*x.values(), dy, True, False)
        torch.testing.assert_close(y, want_y, rtol=6e-4, atol=2e-3)
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() <= 1e-3 * max(w.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_train_step_on_card_matches_plain():
    """One tiny train step's gradients on the kernels against the plain
    scans, with 48 launches of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from focalnet_tpu_torch.train.losses import multiscale_loss

    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 32, 32, 3, generator=g).cuda()
    gt = torch.rand(2, 32, 32, 3, generator=g).cuda()
    grads = []
    for backend in ("cuda", "chunked"):
        model = build_net("1mlp_g2", device="cuda", drop_path_rate=0.0,
                          scan_backend=backend, **TINY).train()
        before = (selective_scan_cuda.launches, selective_scan_bwd_cuda.launches)
        multiscale_loss(model(x), gt)[0].backward()
        torch.cuda.synchronize()
        launched = (selective_scan_cuda.launches - before[0],
                    selective_scan_bwd_cuda.launches - before[1])
        assert launched == ((48, 48) if backend == "cuda" else (0, 0))
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, w in grads[1].items():
        assert (grads[0][k] - w).abs().max().item() <= 1e-3 * w.abs().max().item() + 1e-5, k


@pytest.mark.cuda
def test_variant_forward_on_card_matches_plain():
    """A tiny model of an SS2D variant (the dwconv3 out-norm, the raw z gate,
    force_fp32, no depthwise conv, v1 init) on the kernels against the plain
    scans: the outputs at the model tests' tolerance, 48 K1 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0)).cuda()
    variant = dict(forward_type="v2dwconv3nozact", ssm_conv=1, ssm_init="v1", **TINY)
    outs = []
    for backend in ("cuda", "chunked"):
        model = build_net("1mlp_g2", device="cuda", scan_backend=backend,
                          generator=torch.Generator().manual_seed(3), **variant)
        before = selective_scan_cuda.launches
        with torch.no_grad():
            outs.append(model(x))
        torch.cuda.synchronize()
        assert selective_scan_cuda.launches - before == (48 if backend == "cuda" else 0)
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_loop", [1, 8, 64])  # P = 8, 64, 512 passes
def test_fma_passes_kernel_matches_plain_on_card(n_loop):
    """K3 against its plain version (one FMA per pass against a rounded
    product and sum: rtol 1e-4), on the float4 path, on a ragged size (the
    float4 kernel, then the one-float kernel for the tail), on a view that
    is not 16-byte aligned (the one-float path) and on an empty tensor (no
    kernel), with the kernels each launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    full = torch.rand(1, 1, 192, 4096 + 3, generator=g, device="cuda")
    for x, kernels in ((full[..., :4096].contiguous(), 1), (full.reshape(-1)[:1001], 2),
                       (full.reshape(-1)[1:1002], 1), (full.reshape(-1)[:0], 0)):
        before = fma_passes_cuda.launches
        got = fma_passes_cuda(x, n_loop)
        torch.cuda.synchronize()
        assert fma_passes_cuda.launches == before + kernels
        torch.testing.assert_close(got, fma_passes_ref(x, n_loop), rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_fma_passes_kernel_raises_on_other_dtypes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for dtype in (torch.bfloat16, torch.float64):
        with pytest.raises(ValueError, match="float32"):
            fma_passes_cuda(torch.zeros(8, dtype=dtype, device="cuda"), 1)
