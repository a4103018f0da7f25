"""Parallel execution over device meshes.

The reference's parallelism surface is (a) batched transforms and (b)
MPI-rank fan-out of emulator sampling (SURVEY.md §2.11). The
mapping implemented here:

- **data parallel**: the cosmology batch axis is sharded over the mesh's
  'dp' axis with ``jax.sharding.NamedSharding``; XLA inserts collectives.
- **tensor parallel**: MLP emulator hidden layers are sharded over 'tp'
  (column-parallel first layer, row-parallel second, psum on the way out —
  annotated, XLA-inserted).
- **process parallel** (multi-host sampling fan-out): `distributed.py`
  replaces mpi4py with `jax.distributed` + a single-process fallback.
"""

from .mesh import make_mesh, shard_array, replicate, batch_sharding
from .distributed import (FakeComm, bcast_seed, get_comm, set_common_seed,
                          set_independent_seed, split_ranks)
