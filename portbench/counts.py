"""The yardstick's arithmetic: the card's peaks, the operations, bytes and
exponentials of the selective-scan kernels per call, and the FLOPs of a
forward, all from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity): 3.35 TB/s
of HBM, 67 TFLOP/s of fp32 outside the tensor cores, 132 SMs at a 1980 MHz
top clock, each taking 16 exponentials a clock.  A kernel's least time is the
largest of its bytes read and written once at the memory rate, its fp32
operations at the fp32 rate, and its exponentials at theirs.

K1, the forward scan, per row: 9 L D N + L D operations (the reference's
``flops_selective_scan_fn``: 9 per state and element, 1 for the D term),
D N L exponentials, and u, delta, y (and y_accum) of D L values, B and C of
G N L values, chunk states of D N values per 256 items when the backward
needs them, and A, D, the dt bias once.  K2, the backward: 22 L D N + 10 L D
operations (the forward's 9 again and 13 for the adjoint and its sums), the
same exponentials, and u, delta, dy, du, ddelta, B, C, dB, dC, the chunk
states and the per-channel parameters and their gradients.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SMS = 132
SM_CLOCK_HZ = 1980e6
EXP_PER_CLOCK_PER_SM = 16
KERNEL_CHUNK = 256
EXP_PER_S = EXP_PER_CLOCK_PER_SM * SMS * SM_CLOCK_HZ


def k1_call(L, batch=1, dim=192, N=16, groups=1, in_bytes=4, out_bytes=4,
            accum=False, chunk_states=False):
    """(bytes, fp32 operations, exponentials) of one forward-scan call."""
    n_chunks = -(-L // KERNEL_CHUNK)
    nbytes = (batch * (dim * L * (2 * in_bytes + out_bytes * (2 if accum else 1))
                       + 2 * groups * N * L * in_bytes
                       + (dim * n_chunks * N * 4 if chunk_states else 0))
              + (dim * N + 2 * dim) * 4)
    return nbytes, batch * (9 * L * dim * N + L * dim), batch * dim * N * L


def k2_call(L, batch=1, dim=192, N=16, groups=1, in_bytes=4):
    """(bytes, fp32 operations, exponentials) of one backward-scan call."""
    n_chunks = -(-L // KERNEL_CHUNK)
    nbytes = (batch * (dim * L * (4 * in_bytes + 4) + 2 * groups * N * L * (in_bytes + 4)
                       + dim * n_chunks * N * 4) + 2 * (dim * N + 2 * dim) * 4)
    return nbytes, batch * (22 * L * dim * N + 10 * L * dim), batch * dim * N * L


def bound_s(nbytes, flops, exps):
    """The least time of a call, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S, exps / EXP_PER_S)


def scan_lengths(cfg, hw):
    """The scan lengths of one forward at image size ``hw``, one entry per
    VSSG branch of each of the six stages (scales 1, 1/2, 1/4, each in the
    encoder and the decoder)."""
    H, W = hw
    patches = [cfg["ps_global"]] + ([cfg["ps_local"]] if cfg["gl_merge"] else [])
    return [(H // s // ps) * (W // s // ps) for s in (1, 2, 4) for _ in range(2)
            for ps in patches]


def scan_calls(cfg, hw, batch):
    """One forward's scan calls as [(kernel, L, B, kwargs)], with D = 2
    vssg_dim channels and N = ssm_d_state: per SS2D (``depth`` a branch) two
    rasters, each a forward call and a reverse one that adds the forward's
    output (``y_accum``)."""
    dim, N, depth = 2 * cfg["vssg_dim"], cfg["ssm_d_state"], cfg["depth"]
    calls = []
    for L in scan_lengths(cfg, hw):
        for _ in range(depth * 2):
            calls.append(("k1", L, batch, dict(dim=dim, N=N)))
            calls.append(("k1", L, batch, dict(dim=dim, N=N, accum=True)))
    return calls


def scan_bound_s(cfg, hw, batch, kernel):
    """The summed least time of ``kernel``'s calls in one forward."""
    total = 0.0
    for k, L, b, kw in scan_calls(cfg, hw, batch):
        if k == kernel:
            total += bound_s(*(k1_call if k == "k1" else k2_call)(L, b, **kw))
    return total


def scan_flops(cfg, hw, batch):
    """The scans' fp32 operations in one forward."""
    return sum(k1_call(L, b, dim=kw["dim"], N=kw["N"])[1] for _, L, b, kw in scan_calls(cfg, hw, batch))


def counted_flops(params, cfg, hw, batch):
    """Matrix products and convolutions of one forward of the plain
    reference model on the meta device, by ``FlopCounterMode``.  ``params``:
    the state dict's shapes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import model

    meta = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
    x = torch.empty(batch, *hw, 3, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.forward(meta, x, cfg)
    return float(counter.get_total_flops())


def model_flops(params, cfg, hw, batch):
    """FLOPs of one forward at ``batch`` x ``hw``: the counted products and
    convolutions plus the scans' operations."""
    return counted_flops(params, cfg, hw, batch) + scan_flops(cfg, hw, batch)
