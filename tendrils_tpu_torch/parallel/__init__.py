"""Multi-device frames on `torch.distributed`: the port of
`tendrils_tpu/parallel/`.

The particles are data-parallel: the logic step reads only the grids and
needs no collective. Two layouts share the grids:

  - `sharding`: the grids whole on every rank; each rank's splat sums are
    summed over the ranks once a frame (K2's int64 sums before their
    conversion, so the frame equals the single device's);
  - `spatial`: the grids in row slabs; the splat parts are
    reduce-scattered to each rank's slab, and the flow read all-gathers
    the 2 channels of the decayed flow.

Meshes are `DeviceMesh`es over every rank of the process group: 1-D
(`make_mesh`) or `(hosts, chips)` (`make_multihost_mesh`, with
`initialize_distributed` for `torchrun` launches). `comm` holds the
collectives and their counts; `dryrun` runs both layouts over gloo ranks
on the CPU (`python -m tendrils_tpu_torch.parallel.dryrun 4`).
"""

from .sharding import (ParallelTendrils, initialize_distributed, make_mesh,
                       make_multihost_mesh, parallel_frame, shard_sim)
from .spatial import SpatialTendrils, shard_sim_spatial, spatial_frame

__all__ = ["ParallelTendrils", "SpatialTendrils", "initialize_distributed",
           "make_mesh", "make_multihost_mesh", "parallel_frame", "shard_sim",
           "shard_sim_spatial", "spatial_frame"]
