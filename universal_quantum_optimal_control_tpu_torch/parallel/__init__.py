from . import mc_parallel, mesh  # noqa: F401

from .mc_parallel import make_mean_fidelity, mean_fidelity_local  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MC_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
    mesh_shape,
    rank_device,
    replicated,
    shard_spec,
)
