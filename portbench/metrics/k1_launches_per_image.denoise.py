"""K1 launches per request in the traced stretch: the device's kernels whose
name holds the pattern below, over the stretch's requests.  Counted on the
device's timeline, not by the program's launch counter, which a CUDA graph
would skip."""

from portbench import trace

PATTERNS = ("selective_scan_fwd_kernel",)


def read(run):
    if run.trace is None or not run.trace.iters:
        return None
    _, n = trace.matched_s(run.trace, PATTERNS)
    return n / run.trace.iters if n else None
