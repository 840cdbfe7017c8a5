"""The process mesh, its launcher, and the sequence- and channel-sharded
scans (counterpart of ``focalnet_tpu/parallel``)."""

from focalnet_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh_shape,
    local_rows,
    make_mesh,
    parse_mesh_shape,
    spawn,
)
from focalnet_tpu_torch.parallel.seq_scan import selective_scan_seq_sharded
from focalnet_tpu_torch.parallel.tp_scan import selective_scan_tp

__all__ = ["Mesh", "auto_mesh_shape", "local_rows", "make_mesh", "parse_mesh_shape",
           "selective_scan_seq_sharded", "selective_scan_tp", "spawn"]
