"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one it raises instead of falling
    back to the CPU.  Pass ``"cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def nvidia_smi(query: str = "name,power.limit", fmt: str = "csv,noheader") -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    import subprocess

    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi --query-gpu={query}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
