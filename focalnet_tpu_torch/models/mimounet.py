"""MIMO-UNet assembly (counterpart of ``focalnet_tpu/models/mimounet.py``).

The 3-scale encoder/decoder dehazer: multi-input (x, x/2, x/4 by nearest
downsampling) and multi-output (3 scales, each added to its input).
``forward`` keeps the JAX package's layouts: it takes (B, H, W, 3) NHWC in
[0, 1] and returns ``[out_4, out_2, out_1]`` NHWC; inside, convs run NCHW.
Under ``compute_dtype`` the input is cast once at entry and the three
outputs back to the input's dtype at the end; parameters stay fp32.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from focalnet_tpu_torch.configs import SCAN_BACKENDS, ModelConfig
from focalnet_tpu_torch.models.layers import FAM, SCM, BasicConv, ResBlock, nearest_down2
from focalnet_tpu_torch.models.vssg import VSSG
from focalnet_tpu_torch.utils.flops import mimounet_scan_flops


_DTYPES = {"": None, "float32": None, "fp32": None, "bfloat16": torch.bfloat16}


def config_dtype(name: str):
    """A config's dtype name -> the torch dtype to cast to; None for fp32
    (and for ``""``), where nothing is cast."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} not in {sorted(_DTYPES)}")
    return _DTYPES[name]


class StageStack(nn.Module):
    """EBlock/DBlock body: ``num_res`` VSSGs plus the outer residual, or for
    ``block_type="resblock"`` (the ``baseline`` preset) ``num_res`` ResBlocks
    and no outer residual, as the reference's baseline snapshot has it."""

    def __init__(self, channels: int, cfg: ModelConfig, seq_mesh=None):
        super().__init__()
        c = cfg
        self.residual = c.block_type == "vssg"
        if c.block_type == "resblock":
            self.layers = nn.ModuleList([ResBlock(channels) for _ in range(c.num_res)])
            return
        if c.block_type != "vssg":
            raise ValueError(f"block_type {c.block_type!r} not in ('vssg', 'resblock')")
        self.layers = nn.ModuleList([
            VSSG(
                in_chans=channels, patch_size_global=c.patch_size_global,
                patch_size_local=c.patch_size_local, gl_merge=c.gl_merge,
                depths=c.depths, dim=c.vssg_dim, drop_path_rate=c.drop_path_rate,
                ssm_d_state=c.ssm_d_state, ssm_ratio=c.ssm_ratio,
                ssm_dt_rank=c.ssm_dt_rank, ssm_act=c.ssm_act, ssm_conv=c.ssm_conv,
                ssm_conv_bias=c.ssm_conv_bias, ssm_drop_rate=c.ssm_drop_rate,
                ssm_init=c.ssm_init, forward_type=c.forward_type,
                mlp_ratio=c.mlp_ratio, mlp_act=c.mlp_act,
                mlp_drop_rate=c.mlp_drop_rate, scan_backend=c.scan_backend,
                use_checkpoint=c.use_checkpoint,
                ssm_proj_dtype=config_dtype(c.ssm_proj_dtype),
                ssm_out_dtype=config_dtype(c.ssm_out_dtype),
                seq_mesh=seq_mesh, seq_axis=c.seq_axis, tp_axis=c.tp_axis,
            )
            for _ in range(c.num_res)
        ])

    def forward(self, x):
        res = x
        for layer in self.layers:
            res = layer(res)
        return res + x if self.residual else res


class MIMOUNet(nn.Module):
    """3-scale MIMO-UNet, dims (32, 64, 128).  ``seq_mesh``: the
    :class:`focalnet_tpu_torch.parallel.Mesh` of the sharded SS2D scans,
    sequence-parallel over ``cfg.seq_axis`` or channel-split over
    ``cfg.tp_axis`` (not config; no parameters)."""

    pad_multiple = 32  # three scales, each VSSG patch 2 or 4 at a quarter of the size
    trains = True
    shards_scans = True

    @staticmethod
    def scan_flops(cfg: ModelConfig, hw, batch: int = 1) -> int:
        """The scan cost model's FLOPs of a forward at ``hw``; none
        without VSSG blocks."""
        return mimounet_scan_flops(cfg, hw, batch) if cfg.block_type == "vssg" else 0

    def __init__(self, cfg: ModelConfig, seq_mesh=None):
        super().__init__()
        if cfg.scan_backend not in SCAN_BACKENDS:
            raise ValueError(
                f"scan_backend {cfg.scan_backend!r} not in {SCAN_BACKENDS}")
        self.cfg = cfg
        self.compute_dtype = config_dtype(cfg.compute_dtype)
        d0, d1, d2 = cfg.dims
        self.Encoder = nn.ModuleList([StageStack(d, cfg, seq_mesh) for d in (d0, d1, d2)])
        self.feat_extract = nn.ModuleList([
            BasicConv(3, d0, 3, act=True),
            BasicConv(d0, d1, 3, stride=2, act=True),
            BasicConv(d1, d2, 3, stride=2, act=True),
            BasicConv(d2, d1, 4, stride=2, act=True, transpose=True),
            BasicConv(d1, d0, 4, stride=2, act=True, transpose=True),
            BasicConv(d0, 3, 3, act=False),
        ])
        self.Decoder = nn.ModuleList([StageStack(d, cfg, seq_mesh) for d in (d2, d1, d0)])
        self.Convs = nn.ModuleList([
            BasicConv(2 * d1, d1, 1, act=True),
            BasicConv(2 * d0, d0, 1, act=True),
        ])
        self.ConvsOut = nn.ModuleList([
            BasicConv(d2, 3, 3, act=False),
            BasicConv(d1, 3, 3, act=False),
        ])
        self.FAM1 = FAM(d2)
        self.FAM2 = FAM(d1)
        self.SCM1 = SCM(d2)
        self.SCM2 = SCM(d1)

    def forward(self, x):
        """x: (B, H, W, 3) hazy image in [0, 1], H and W multiples of 32.
        Returns [out_4, out_2, out_1] NHWC at 1/4, 1/2 and full resolution,
        in x's dtype."""
        in_dtype = x.dtype
        x = x.permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x_2 = nearest_down2(x)
        x_4 = nearest_down2(x_2)
        z2 = self.SCM2(x_2)
        z4 = self.SCM1(x_4)

        outputs = []
        res1 = self.Encoder[0](self.feat_extract[0](x))
        z = self.FAM2(self.feat_extract[1](res1), z2)
        res2 = self.Encoder[1](z)
        z = self.FAM1(self.feat_extract[2](res2), z4)
        z = self.Encoder[2](z)

        z = self.Decoder[0](z)
        z_ = self.ConvsOut[0](z)
        z = self.feat_extract[3](z)
        outputs.append(z_ + x_4)

        z = self.Convs[0](torch.cat([z, res2], dim=1))
        z = self.Decoder[1](z)
        z_ = self.ConvsOut[1](z)
        z = self.feat_extract[4](z)
        outputs.append(z_ + x_2)

        z = self.Convs[1](torch.cat([z, res1], dim=1))
        z = self.Decoder[2](z)
        z = self.feat_extract[5](z)
        outputs.append(z + x)
        return [o.permute(0, 2, 3, 1).to(in_dtype) for o in outputs]


@contextlib.contextmanager
def mesh_free(model: nn.Module):
    """Within the block every SS2D of ``model`` runs its dense path (the
    JAX package's mesh-free twin with the same parameters), whether its
    mesh shards the scans over ``seq_axis`` or ``tp_axis``."""
    from focalnet_tpu_torch.models.ss2d import SS2D

    ops = [m for m in model.modules() if isinstance(m, SS2D)]
    meshes = [m.seq_mesh for m in ops]
    for m in ops:
        m.seq_mesh = None
    try:
        yield model
    finally:
        for m, mesh in zip(ops, meshes):
            m.seq_mesh = mesh
