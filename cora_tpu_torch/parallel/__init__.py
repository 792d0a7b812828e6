"""Device-mesh sharding layer (port of ``cora_tpu/parallel``).

Replaces the reference's MPI distribution (caput.mpiarray) with
``torch.distributed``: one process per device (``torchrun``), a
``DeviceMesh`` over the default process group (NCCL on CUDA, gloo on the
CPU), sharded arrays as DTensors with ``Shard(axis)`` placements.  The
``MPIArray.redistribute(axis=…)`` global transposes become DTensor
redistributions (all-to-all), and each program runs SPMD on every rank's
shard.
"""

from .checkpoint import (  # noqa: F401
    abstract_like,
    load_container,
    restore_sharded,
    save_container,
    save_sharded,
)
from .distributed import initialize, make_pod_mesh  # noqa: F401
from .mesh import (  # noqa: F401
    make_mesh,
    mkfullsky_sharded,
    synthesize_cube_sharded,
    synthesize_cube_sharded_2d,
    synthesize_cube_sims_sharded,
    shard_over,
    redistribute,
)
