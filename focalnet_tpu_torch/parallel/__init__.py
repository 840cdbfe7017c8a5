"""The process mesh, its launcher and the sequence-sharded scan
(counterpart of ``focalnet_tpu/parallel``).  The channel-split scan
(``tp_scan``) and data parallelism are not ported yet (ROADMAP.md Queue 1
item 6)."""

from focalnet_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh_shape, spawn
from focalnet_tpu_torch.parallel.seq_scan import selective_scan_seq_sharded

__all__ = ["Mesh", "make_mesh", "parse_mesh_shape", "selective_scan_seq_sharded", "spawn"]
