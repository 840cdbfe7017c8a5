"""Selective-scan ops: the dispatcher, the plain scans and the cross-scan
layout functions.  The Hopper kernel's wrapper is
:mod:`focalnet_tpu_torch.ops.selective_scan_cuda`."""

from focalnet_tpu_torch.ops.cross_scan import (
    cross_merge,
    cross_merge_1b1,
    cross_scan,
    cross_scan_1b1,
)
from focalnet_tpu_torch.ops.scan_chunked import selective_scan_chunked
from focalnet_tpu_torch.ops.scan_matrix import selective_scan_matrix
from focalnet_tpu_torch.ops.scan_ref import selective_scan_assoc, selective_scan_ref
from focalnet_tpu_torch.ops.selective_scan import BACKENDS, selective_scan

__all__ = [
    "BACKENDS",
    "cross_merge",
    "cross_merge_1b1",
    "cross_scan",
    "cross_scan_1b1",
    "selective_scan",
    "selective_scan_assoc",
    "selective_scan_chunked",
    "selective_scan_matrix",
    "selective_scan_ref",
]
