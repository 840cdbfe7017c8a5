"""VSSBlock and VSSG (counterpart of ``focalnet_tpu/models/vssg.py``).

A VSSG is: patch-embed (conv k=ps, s=ps + LayerNorm) -> VSSBlocks (pre-norm
SS2D residual + pre-norm MLP residual, DropPath) -> patch-unembed (1x1 conv
to C*ps^2 + PixelShuffle).  ``gl_merge`` selects a global branch (patch
``patch_size_global``) and a local one (``patch_size_local``) whose
un-embeds are summed; otherwise the global branch alone.  VSSG takes and
returns NCHW; its blocks work on NHWC.
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from focalnet_tpu_torch.models.layers import Conv2d, LayerNorm, Permute
from focalnet_tpu_torch.models.ss2d import SS2D, DropPath, Dropout, Mlp


def _replay_masks(generators):
    """``context_fn`` of ``torch.utils.checkpoint`` for a block whose DropPath
    and Dropout draw from explicit generators, which the checkpoint's own
    ``preserve_rng_state`` does not cover: the recomputation in the backward
    draws from the generators' states as the forward found them (the same
    masks), and leaves them where it found them."""
    start = [g.get_state() for g in generators]

    @contextlib.contextmanager
    def replay():
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, start):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(generators, now):
                g.set_state(s)

    return contextlib.nullcontext(), replay()


class VSSBlock(nn.Module):
    """Pre-norm SS2D residual + optional pre-norm MLP residual on NHWC.

    ``use_checkpoint`` recomputes the block in the backward instead of
    keeping its activations (the JAX block's ``nn.remat``), with the same
    DropPath and Dropout masks."""

    def __init__(self, hidden_dim, drop_path=0.0, ssm_d_state=16, ssm_ratio=2.0,
                 ssm_dt_rank: Any = "auto", ssm_act="silu", ssm_conv=3,
                 ssm_conv_bias=True, ssm_drop_rate=0.0, ssm_init="v0",
                 forward_type="v4", mlp_ratio=4.0, mlp_act="gelu",
                 mlp_drop_rate=0.0, scan_backend="auto", use_checkpoint=False,
                 ssm_proj_dtype=None, ssm_out_dtype=None, seq_mesh=None, seq_axis=None,
                 tp_axis=None):
        super().__init__()
        self.ssm_branch = ssm_ratio > 0
        self.mlp_branch = mlp_ratio > 0
        self.use_checkpoint = use_checkpoint
        self.drop_path = DropPath(drop_path)
        if self.ssm_branch:
            self.norm = LayerNorm(hidden_dim, eps=1e-5)
            self.op = SS2D(
                d_model=hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                dt_rank=ssm_dt_rank, act=ssm_act, d_conv=ssm_conv,
                conv_bias=ssm_conv_bias, dropout=ssm_drop_rate,
                initialize=ssm_init, forward_type=forward_type,
                scan_backend=scan_backend, proj_dtype=ssm_proj_dtype,
                out_dtype=ssm_out_dtype, seq_mesh=seq_mesh, seq_axis=seq_axis,
                tp_axis=tp_axis,
            )
        if self.mlp_branch:
            self.norm2 = LayerNorm(hidden_dim, eps=1e-5)
            self.mlp = Mlp(hidden_dim, int(hidden_dim * mlp_ratio), act=mlp_act,
                           drop=mlp_drop_rate)

    def _body(self, x):
        if self.ssm_branch:
            x = x + self.drop_path(self.op(self.norm(x)))
        if self.mlp_branch:
            x = x + self.drop_path(self.mlp(self.norm2(x)))
        return x

    def forward(self, x):
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return self._body(x)
        generators = list({id(m.generator): m.generator for m in self.modules()
                           if isinstance(m, (DropPath, Dropout))
                           and m.generator is not None}.values())
        return checkpoint(self._body, x, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: _replay_masks(generators))


class _BlockChain(nn.Module):
    """``seq_global`` or ``seq_local``: one chain of VSSBlocks."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class GlobalScan(nn.Module):
    """One depth group of the single-branch VSSG (the reference's GlobalScan)."""

    def __init__(self, blocks):
        super().__init__()
        self.seq_global = _BlockChain(blocks)

    def forward(self, x):
        return self.seq_global(x)


class GlobalLocalScan(nn.Module):
    """One depth group of the dual-branch VSSG (the reference's
    GlobalLocalScan): the group's global blocks, then its local ones."""

    def __init__(self, global_blocks, local_blocks):
        super().__init__()
        self.seq_global = _BlockChain(global_blocks)
        self.seq_local = _BlockChain(local_blocks)

    def forward(self, xg, xl):
        return self.seq_global(xg), self.seq_local(xl)


def _patch_embed(in_chans, dim, ps):
    """conv(k=ps, s=ps) to NHWC + LayerNorm (``patch_embed_*.{0,2}``)."""
    return nn.Sequential(Conv2d(in_chans, dim, ps, stride=ps), Permute(0, 2, 3, 1),
                         LayerNorm(dim, eps=1e-5))


def _patch_unembed(dim, out_chans, ps):
    """NCHW 1x1 conv to out_chans*ps^2 + PixelShuffle(ps) (``patch_unembed_*.1``)."""
    return nn.Sequential(Permute(0, 3, 1, 2), Conv2d(dim, out_chans * ps * ps, 1),
                         nn.PixelShuffle(ps))


class VSSG(nn.Module):
    """Visual State Space Group: the stage module of the VSSG presets."""

    def __init__(self, in_chans, patch_size_global=2, patch_size_local=2,
                 gl_merge=False, depths: Sequence[int] = (2,), dim=96,
                 drop_path_rate=0.1, **block_kw):
        super().__init__()
        self.gl_merge = gl_merge
        dpr = list(np.linspace(0.0, drop_path_rate, sum(depths)))

        def blocks(offset, depth):
            return [VSSBlock(dim, drop_path=float(dpr[offset + d]), **block_kw)
                    for d in range(depth)]

        self.patch_embed_global = _patch_embed(in_chans, dim, patch_size_global)
        if gl_merge:
            self.patch_embed_local = _patch_embed(in_chans, dim, patch_size_local)
        layers, offset = [], 0
        for depth in depths:
            layers.append(GlobalLocalScan(blocks(offset, depth), blocks(offset, depth))
                          if gl_merge else GlobalScan(blocks(offset, depth)))
            offset += depth
        self.layers = nn.ModuleList(layers)
        self.patch_unembed_global = _patch_unembed(dim, in_chans, patch_size_global)
        if gl_merge:
            self.patch_unembed_local = _patch_unembed(dim, in_chans, patch_size_local)

    def forward(self, x):
        """x: (B, C, H, W) -> (B, C, H, W)."""
        if not self.gl_merge:
            xg = self.patch_embed_global(x)
            for layer in self.layers:
                xg = layer(xg)
            return self.patch_unembed_global(xg)
        xg, xl = self.patch_embed_global(x), self.patch_embed_local(x)
        for layer in self.layers:
            xg, xl = layer(xg, xl)
        return self.patch_unembed_global(xg) + self.patch_unembed_local(xl)
