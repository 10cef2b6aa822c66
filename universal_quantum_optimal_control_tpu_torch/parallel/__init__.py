from . import mc_parallel  # noqa: F401

from .mc_parallel import mean_fidelity_local  # noqa: F401
