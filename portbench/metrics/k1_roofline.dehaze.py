"""K1's share of its roofline: the summed least times of the forward's scans
(``counts.scan_bound_s``) per request times the traced requests, over the
device time of the kernels named below in the traced stretch."""

from portbench import trace

PATTERNS = ("selective_scan_fwd_kernel",)


def read(run):
    return trace.roofline(run, "k1", PATTERNS)
