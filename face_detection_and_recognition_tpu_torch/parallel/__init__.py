"""Multi-device: device meshes, sharding rules, the collectives of a sharded
run, and training over a mesh (the JAX package's ``parallel/``)."""
from .mesh import make_mesh  # noqa: F401
from .sharding import (batch_sharding, data_parallel,  # noqa: F401
                       replicate_to_mesh)
