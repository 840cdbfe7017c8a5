"""What the traffic kinds share: the model built from the configuration's
file and the seed, the card's clock and memory, and the switch to plain
fp32 for the reference."""

from __future__ import annotations

import gc

import numpy as np


def shape_cfg(cfg: dict) -> dict:
    """The sizes the yardstick and the reference take from a configuration."""
    return {k: cfg[k] for k in ("vssg_dim", "ssm_d_state", "depth", "drop_path_rate",
                                "gl_merge", "ps_global", "ps_local")}


def check_config(model_cfg, cfg: dict) -> None:
    """The model built must be the configuration's file: every size the
    file states, as the program's config holds it."""
    got = {"vssg_dim": model_cfg.vssg_dim, "ssm_d_state": model_cfg.ssm_d_state,
           "depth": sum(model_cfg.depths), "drop_path_rate": model_cfg.drop_path_rate,
           "gl_merge": model_cfg.gl_merge, "ps_global": model_cfg.patch_size_global,
           "ps_local": model_cfg.patch_size_local, "dims": list(model_cfg.dims),
           "mlp_ratio": model_cfg.mlp_ratio, "ssm_ratio": model_cfg.ssm_ratio,
           "num_res": model_cfg.num_res, "forward_type": model_cfg.forward_type,
           "compute_dtype": model_cfg.compute_dtype, "use_checkpoint": model_cfg.use_checkpoint}
    wrong = {k: (v, cfg[k]) for k, v in got.items() if k in cfg and v != cfg[k]}
    if wrong:
        raise ValueError(f"the model built differs from the configuration: {wrong}")


def weight_seed(seed: int) -> int:
    return int(np.random.SeedSequence([int(seed) % 2**64, 7]).generate_state(1)[0])


def shapes(cfg: dict) -> dict:
    """{name: shape} of the configuration's parameters, from the program's
    model on the meta device."""
    import torch

    from focalnet_tpu_torch.models import build_net

    model = build_net(cfg["preset"], device="meta", **cfg.get("overrides", {}))
    check_config(model.cfg, cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def build(cfg: dict, seed: int, dev, control=None):
    """The program's model of ``cfg`` on ``dev`` with the weights of the
    seed (``weights.make``), and those weights.  Under ``control="tf32"``
    matrix products and convolutions run in TF32."""
    import torch

    from focalnet_tpu_torch.models import build_net
    from portbench import weights

    model = build_net(cfg["preset"], device=dev, **cfg.get("overrides", {}))
    check_config(model.cfg, cfg)
    state = weights.make({k: tuple(v.shape) for k, v in model.state_dict().items()},
                         weight_seed(seed), dev)
    model.load_state_dict(state)
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif control is None:
        fp32_only()
    else:
        raise ValueError(f"no control {control!r}")
    return model, state


def syncer(dev):
    import torch

    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


def reset_peak(run, dev) -> None:
    """Start the window's memory peak; the set-up's goes into the run's."""
    import torch

    if dev.type == "cuda":
        run.memory_peak_bytes = max(run.memory_peak_bytes, torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)


def peak(run, dev) -> int:
    """The bytes allocated at most since :func:`reset_peak`; the run's peak
    takes them in."""
    import torch

    now = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.memory_peak_bytes = max(run.memory_peak_bytes, now)
    return now


def free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def fp32_only() -> None:
    """The reference's precision: fp32 products, TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
