"""The multi-device paths: process groups and the rank launcher, the ring
all-pairs schedule, the sharded step with the replicated-tree Barnes-Hut,
and the distributed Barnes-Hut with its ring and LET near fields.
Counterpart of `parallelnbody_tpu/parallel/`: each rank is a process, and
its RingGroup takes the place of the JAX package's mesh axis."""

from parallelnbody_tpu_torch.parallel.mesh import (
    RankPool, RingGroup, gather_state, init_distributed, launch,
    make_ring_mesh, scatter_state, shard_state, state_pspecs)
from parallelnbody_tpu_torch.parallel.ring import ring_accel
from parallelnbody_tpu_torch.parallel.sharded import (make_sharded_run,
                                                      make_sharded_step)
from parallelnbody_tpu_torch.parallel.distributed import (
    dist_bh_accel, make_distributed_run)

__all__ = [
    "make_ring_mesh",
    "shard_state",
    "state_pspecs",
    "ring_accel",
    "make_sharded_step",
    "make_sharded_run",
    "dist_bh_accel",
    "make_distributed_run",
    "RankPool",
    "RingGroup",
    "launch",
    "init_distributed",
    "gather_state",
    "scatter_state",
]
