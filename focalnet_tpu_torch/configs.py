"""Model presets and the training config for the PyTorch port (counterpart
of ``focalnet_tpu/configs.py``).

The port keeps its own copy: it imports nothing of ``focalnet_tpu``.  Only the
fields the port reads are here, with the JAX defaults, the mesh fields
(``seq_axis``, ``tp_axis``, ``data_axis``, ``mesh_shape``, ``mesh_axes``)
among them.

    baseline  — conv ResBlock x 1 per stage, no outer residual
    1mlp      — VSSG, gl_merge=True, ps_global=4, ps_local=2
    1mlp_g2   — VSSG, gl_merge=False, ps_global=2 (the flagship)
    1mlp_g4   — VSSG, gl_merge=False, ps_global=4
    mambair_dn — MambaIR's colour denoiser (:class:`MambaIRConfig`): one
                 scale, 6 residual groups of 6 SS2D + channel-attention blocks
                 at width 180; serves and evaluates, does not train
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

SCAN_BACKENDS = ("auto", "cuda", "chunked", "assoc", "ref")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MIMOUNet + stage-module architecture."""

    # assembly
    dims: Tuple[int, int, int] = (32, 64, 128)
    num_res: int = 1
    block_type: str = "vssg"  # "vssg" | "resblock"

    # VSSG
    gl_merge: bool = False
    patch_size_global: int = 2
    patch_size_local: int = 2
    depths: Tuple[int, ...] = (2,)
    vssg_dim: int = 96
    drop_path_rate: float = 0.1

    # SS2D
    ssm_d_state: int = 16
    ssm_ratio: float = 2.0
    ssm_dt_rank: Any = "auto"
    ssm_act: str = "silu"
    ssm_conv: int = 3
    ssm_conv_bias: bool = True
    ssm_drop_rate: float = 0.0
    ssm_init: str = "v0"
    forward_type: str = "v4"
    # dtype of the x_proj / dt_proj operands (summed in fp32 either way);
    # "" keeps the activations' dtype
    ssm_proj_dtype: str = ""
    # dtype of the scan's output y, its y_accum chain and the raster sum; ""
    # keeps the reference's fp32 ("oflex"); the scan state stays fp32 either way
    ssm_out_dtype: str = ""

    # MLP branch
    mlp_ratio: float = 1.0
    mlp_act: str = "gelu"
    mlp_drop_rate: float = 0.0

    # recompute every VSSBlock in the backward instead of keeping its activations
    use_checkpoint: bool = False
    # auto: the CUDA kernel for CUDA tensors, the chunked scan for CPU tensors
    scan_backend: str = "auto"  # auto | cuda | chunked | assoc | ref
    compute_dtype: str = "float32"  # params fp32; bfloat16 activations opt-in
    # multi-rank: mesh axis names for sequence-parallel SS2D scans (L = H*W is
    # sharded over `seq_axis`; `data_axis` names the batch axis).  The mesh
    # itself is passed to build_net(seq_mesh=...): it is not config.
    seq_axis: Any = None    # Optional[str]
    data_axis: Any = None   # Optional[str]
    # channel-split (tensor-parallel) SS2D scans over this mesh axis (whole
    # B/C groups or sub-group shards, parallel/tp_scan.py); not with seq_axis
    tp_axis: Any = None     # Optional[str]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the reference's ``ITS/main.py`` defaults)."""

    data_dir: str = "dataset/ITS"
    batch_size: int = 4
    learning_rate: float = 1e-4
    num_epoch: int = 300
    warmup_epochs: int = 3
    lr_min: float = 1e-6
    grad_clip: float = 0.001  # clip_grad_norm_(0.001) before every Adam step
    fft_loss_weight: float = 0.1  # loss = content + 0.1 * fft
    # micro-batches per optimizer step: activation memory scales with
    # batch_size / grad_accum, the effective batch stays batch_size
    grad_accum: int = 1
    print_freq: int = 100
    num_worker: int = 8
    save_freq: int = 10
    valid_freq: int = 10
    valid_batch: int = 1  # images per validation forward (same metrics)
    crop_size: int = 256
    seed: int = 1234
    model_save_dir: str = "results/weights"
    # the process mesh (--mesh_shape): None = data parallel over the largest
    # device count dividing batch_size; (N,) over ("data",); (D, M) over
    # ("data", "seq")
    mesh_shape: Any = None  # Optional[Tuple[int, ...]]
    mesh_axes: Tuple[str, ...] = ("data",)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MambaIRConfig:
    """MambaIR (Guo et al., ECCV 2024; ``basicsr/archs/mambair_arch.py``)
    with ``upscale`` 1 and no upsampler: the colour Gaussian denoiser.  The
    SS2D fields are :class:`ModelConfig`'s; ``ssm_ratio`` is MambaIR's
    ``mlp_ratio``, which it passes to SS2D as ``expand``.  Its other SS2D
    settings are SS2D's defaults (VMamba v0's operator)."""

    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)  # blocks per residual group
    ssm_d_state: int = 16
    ssm_ratio: float = 2.0
    compress_ratio: int = 3   # CAB: embed_dim -> embed_dim // compress_ratio
    squeeze_factor: int = 30  # channel attention: embed_dim -> embed_dim // squeeze_factor
    img_range: float = 1.0
    rgb_mean: Tuple[float, float, float] = (0.4488, 0.4371, 0.4040)
    scan_backend: str = "auto"

    def replace(self, **kw) -> "MambaIRConfig":
        return dataclasses.replace(self, **kw)


PRESETS = {
    "baseline": ModelConfig(block_type="resblock", num_res=1),
    "1mlp": ModelConfig(
        gl_merge=True, patch_size_global=4, patch_size_local=2, mlp_ratio=1.0
    ),
    "1mlp_g2": ModelConfig(
        gl_merge=False, patch_size_global=2, patch_size_local=2, mlp_ratio=1.0
    ),
    "1mlp_g4": ModelConfig(
        gl_merge=False, patch_size_global=4, patch_size_local=2, mlp_ratio=1.0
    ),
    "mambair_dn": MambaIRConfig(),
}
