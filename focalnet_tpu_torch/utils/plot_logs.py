"""Training-log curves (counterpart of ``focalnet_tpu/utils/plot_logs.py``).

Reads the lines the trainer writes to ``train.log`` in the reference's
formats:

    "Time: ... Loss content: %7.4f Loss fft: %7.4f"      (every print_freq iterations)
    "EPOCH: %02d ... Epoch Pixel Loss: ... Epoch FFT Loss: ..."   (every epoch)
    "%03d epoch \\n Average PSNR %.2f dB"                 (every validated epoch)

and plots PSNR, pixel-loss and FFT-loss curves, PSNR clamped to a band
(28-50 dB, the reference's) unless told otherwise.  Plotting needs
matplotlib; parsing does not.

    python -m focalnet_tpu_torch.utils.plot_logs results/weights/train.log [...]
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

PSNR_RE = re.compile(r"Average PSNR\s+([0-9.]+)\s*dB")
EPOCH_RE = re.compile(r"^(\d+)\s+epoch")
EPOCH_HDR_RE = re.compile(r"^EPOCH:\s*(\d+)")
LOSS_RE = re.compile(r"Loss content:\s*([0-9.]+)\s+Loss fft:\s*([0-9.]+)")
# the per-epoch summary: the only loss record when print_freq exceeds the
# iterations of an epoch
EPOCH_LOSS_RE = re.compile(
    r"Epoch Pixel Loss:\s*([0-9.]+)\s+Epoch FFT Loss:\s*([0-9.]+)")


def parse_log(path: str) -> Dict[str, List[Tuple[float, float]]]:
    """{"psnr": [(epoch, dB)], "content": [(x, loss)], "fft": [(x, loss)]}.

    The loss curves come from the per-iteration lines (x = their index)
    where there are any, else from the per-epoch summaries (x = the epoch of
    the "EPOCH:" header before each, so a resumed run's appended log keeps
    its epochs)."""
    psnr, content, fft = [], [], []
    ep_content, ep_fft = [], []
    last_epoch = None
    hdr_epoch = None
    n_epoch_loss = 0
    with open(path) as f:
        for line in f:
            m = EPOCH_HDR_RE.match(line.strip())
            if m:
                hdr_epoch = int(m.group(1))
            m = EPOCH_RE.match(line.strip())
            if m:
                last_epoch = int(m.group(1))
            m = PSNR_RE.search(line)
            if m:
                psnr.append((float(last_epoch or len(psnr)), float(m.group(1))))
            m = LOSS_RE.search(line)
            if m:
                content.append((len(content), float(m.group(1))))
                fft.append((len(fft), float(m.group(2))))
            m = EPOCH_LOSS_RE.search(line)
            if m:
                n_epoch_loss += 1
                x = float(hdr_epoch if hdr_epoch is not None else n_epoch_loss)
                ep_content.append((x, float(m.group(1))))
                ep_fft.append((x, float(m.group(2))))
    if not content:
        content, fft = ep_content, ep_fft
    return {"psnr": psnr, "content": content, "fft": fft}


def plot_logs(paths, labels=None, out: str = "curves.png",
              psnr_band: Optional[Tuple[float, float]] = (28.0, 50.0)) -> str:
    """Plot the PSNR, pixel and FFT curves of one or more logs side by side
    into ``out``; returns ``out``."""
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("plot_logs needs matplotlib, which is not installed; "
                           "parse_log reads the curves without it") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or [str(p) for p in paths]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for path, label in zip(paths, labels):
        d = parse_log(path)
        if d["psnr"]:
            xs, ys = zip(*d["psnr"])
            if psnr_band:
                ys = [min(max(y, psnr_band[0]), psnr_band[1]) for y in ys]
            axes[0].plot(xs, ys, label=label)
        for ax, key in ((axes[1], "content"), (axes[2], "fft")):
            if d[key]:
                xs, ys = zip(*d[key])
                ax.plot(xs, ys, label=label)
    for ax, title in zip(axes, ["PSNR (dB)", "Pixel loss", "FFT loss"]):
        ax.set_title(title)
        if ax.get_legend_handles_labels()[0]:
            ax.legend()
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


if __name__ == "__main__":
    import sys

    print(plot_logs(sys.argv[1:] or ["results/weights/train.log"]))
