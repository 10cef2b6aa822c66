from .plots import mc_fidelity_estimate  # noqa: F401
from .plots_su4 import fidelity_by_std_su4, fidelity_grid_su4  # noqa: F401
