"""MambaIR's colour denoiser in the port (``--preset mambair_dn``) against the
plain reference of the benchmark (``portbench/reference/mambair.py``, written
from the published equations, no module of the port): the whole forward at a
small size and one block at the published widths, on the CPU with the
chunked scan and seeded random weights; the serve path; the state dict's
names and size; the CLI's refusals.  The card-marked tests hold K1 at
MambaIR's scan (D = 360, L = 321 x 481) against the plain scan and count a
forward's launches; they skip without a card."""

import io
import os

import numpy as np
import pytest
import torch

from focalnet_tpu_torch.data.png import read_png, write_png
from focalnet_tpu_torch.evaluation.infer import u8_forward
from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import MambaIR, build_net, model_class
from focalnet_tpu_torch.ops import selective_scan
from focalnet_tpu_torch.ops.selective_scan_cuda import selective_scan_cuda
from focalnet_tpu_torch.utils.convert import save_checkpoint
from portbench import weights_mambair
from portbench.reference import mambair as ref

torch.set_num_threads(2)

REF_CFG = {"img_range": 1.0, "rgb_mean": [0.4488, 0.4371, 0.4040]}
SMALL = dict(embed_dim=60, depths=(2, 2))  # d_inner 120, CAB 20, attention 2
PUBLISHED_BLOCK = dict(depths=(1,))        # 180 / 360, one group of one block
# fp32 against fp32: the chunked scan against the blocked one, MKL's and
# oneDNN's sums against F.conv2d's and einsum's, through a few blocks.  The
# gaps seen are 4.2e-7 (small) and 7.2e-7 (published widths); bf16 products
# in the blocks move the output by 6.4e-3 to 7.2e-3, far outside.
ATOL = 2e-5


def _model(seed, **overrides):
    model = build_net("mambair_dn", device="cpu", scan_backend="chunked", **overrides)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = weights_mambair.make(shapes, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed)
    for k, v in state.items():  # the skip scales and norms off their init, so they count
        if "skip_scale" in k or ".ln_" in k or "norm." in k:
            state[k] = v + 0.3 * torch.randn(v.shape, generator=g)
    model.load_state_dict(state)
    return model, state


def _gap(model, state, x, bf16=False):
    with torch.no_grad():
        want = ref.forward(state, x, REF_CFG)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
            got = model(x).float()
    return float((got - want).abs().max())


@pytest.mark.parametrize("overrides, hw", [(SMALL, (13, 19)), (PUBLISHED_BLOCK, (12, 16))])
def test_forward_matches_the_reference(overrides, hw):
    model, state = _model(11, **overrides)
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(3))
    assert _gap(model, state, x) < ATOL
    # the check catches the block's products rounded to bf16
    assert _gap(model, state, x, bf16=True) > 50 * ATOL


def test_serve_path_matches_the_reference(tmp_path):
    """``u8_forward`` (uint8 upload, /255 on the device, the one output) and
    ``--mode serve --preset mambair_dn`` at the published widths and depth,
    which pads to nothing: its PNG is the reference's answer rounded to 8
    bits."""
    img = np.random.default_rng(0).integers(0, 256, (1, 11, 17, 3), dtype=np.uint8)
    x = torch.from_numpy(img).float() / 255.0
    model, state = _model(5, embed_dim=30)
    got = u8_forward(model, torch.device("cpu"))(img)
    assert got.shape == (1, 11, 17, 3)
    assert float((got - ref.forward(state, x, REF_CFG)).abs().max()) < ATOL

    model, state = _model(6)
    want = ref.forward(state, x, REF_CFG)

    save_checkpoint(str(tmp_path / "m.pkl"), model.state_dict())
    write_png(str(tmp_path / "in.png"), img[0])
    out = io.StringIO()
    result = main(["--mode", "serve", "--preset", "mambair_dn", "--device", "cpu",
                   "--scan_backend", "chunked",
                   "--test_model", str(tmp_path / "m.pkl"),
                   "--model_save_dir", str(tmp_path / "w"), "--result_dir", str(tmp_path / "r")],
                  inp=io.StringIO(f"{tmp_path / 'in.png'}\t{tmp_path / 'out.png'}\n"), out=out)
    assert result["count"] == 1 and out.getvalue().splitlines()[-1].startswith("OK")
    served = read_png(str(tmp_path / "out.png")).astype(np.float64)
    ideal = np.clip(want[0].numpy(), 0, 1) * 255.0
    assert served.shape == (11, 17, 3) and np.abs(served - ideal).max() <= 0.5 + 1e-3


def test_state_dict_is_mambairs():
    """MambaIR's own names, so that a released checkpoint loads by name, and
    its size: 20,173,539 parameters at the published widths."""
    model = build_net("mambair_dn", device="meta")
    assert isinstance(model, MambaIR) and model_class("mambair_dn") is MambaIR
    assert (MambaIR.pad_multiple, MambaIR.trains, MambaIR.shards_scans) == (1, False, False)
    assert model_class("1mlp_g2").pad_multiple == 32
    assert sum(p.numel() for p in model.parameters()) == 20_173_539
    keys = set(model.state_dict())
    block = "layers.5.residual_group.blocks.5."
    for k in ("conv_first.weight", "patch_embed.norm.weight", "layers.0.conv.weight",
              "norm.bias", "conv_after_body.weight", "conv_last.bias",
              block + "ln_1.weight", block + "skip_scale", block + "ln_2.bias",
              block + "skip_scale2", block + "self_attention.in_proj.weight",
              block + "self_attention.x_proj_weight", block + "self_attention.out_norm.weight",
              block + "conv_blk.cab.0.weight", block + "conv_blk.cab.2.bias",
              block + "conv_blk.cab.3.attention.1.weight",
              block + "conv_blk.cab.3.attention.3.bias"):
        assert k in keys, k
    assert len(keys) == 10 + 6 * 2 + 36 * 25
    assert model.layers[0].residual_group.blocks[0].self_attention.x_proj_weight.shape == \
        (4, 12 + 2 * 16, 360)


def test_cli_refuses_training_and_foreign_sizes(tmp_path):
    with pytest.raises(SystemExit, match="does not train"):
        main(["--mode", "train", "--preset", "mambair_dn", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "w")
    with pytest.raises(SystemExit, match="has no vssg_dim"):
        main(["--mode", "infer", "--preset", "mambair_dn", "--device", "cpu",
              "--vssg_dim", "16", "--input", str(tmp_path),
              "--model_save_dir", str(tmp_path / "w"), "--result_dir", str(tmp_path / "r")])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_forward_kernel_at_mambairs_scan_on_card():
    """K1 at a 321 x 481 image's scan, L = 154,401 (33 past a multiple of the
    256-item chunk), over MambaIR's d_inner = 360 channels: forward, and
    reverse with y_accum, against the plain scan."""
    _card()
    g = torch.Generator().manual_seed(0)
    L, dim, N = 321 * 481, 360, 16
    x = dict(u=torch.randn(1, dim, L, generator=g) * 0.5,
             delta=torch.rand(1, dim, L, generator=g) * 0.5,
             A=-0.5 - 2 * torch.rand(dim, N, generator=g),
             B=torch.randn(1, 1, N, L, generator=g) * 0.5,
             C=torch.randn(1, 1, N, L, generator=g) * 0.5,
             D=torch.randn(dim, generator=g), delta_bias=0.3 * torch.randn(dim, generator=g))
    x = {k: v.cuda() for k, v in x.items()}
    yacc = torch.randn(1, dim, L, generator=g).cuda()
    for reverse, acc in ((False, None), (True, yacc)):
        kw = dict(delta_softplus=True, reverse=reverse, y_accum=acc)
        with torch.no_grad():
            before = selective_scan_cuda.launches
            got = selective_scan_cuda(**x, **kw)
            torch.cuda.synchronize()
            assert selective_scan_cuda.launches == before + 1
            want = selective_scan(**x, backend="chunked", **kw)
        torch.testing.assert_close(got, want, rtol=6e-4, atol=2e-3)


@pytest.mark.cuda
def test_forward_launches_144_kernels_on_card():
    """A MambaIR forward at the published depth: four K1 launches a block, 36
    blocks."""
    _card()
    model = build_net("mambair_dn", device="cuda")
    before = selective_scan_cuda.launches
    with torch.inference_mode():
        model(torch.rand(1, 64, 48, 3, device="cuda"))
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches - before == 144
