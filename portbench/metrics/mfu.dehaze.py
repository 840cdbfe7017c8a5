"""The forward's model FLOPs (``counts.model_flops``) times the window's images
per second, as a share of the cards' fp32 peak (67 TFLOP/s each; TF32 is
off)."""

from portbench import counts


def read(run):
    if not run.window_s or not run.flops_per_image:
        return None
    rate = run.images / run.window_s
    return 100.0 * rate * run.flops_per_image / (counts.FP32_FLOPS_PER_S * run.chips)
