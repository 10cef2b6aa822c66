from . import bloch, compare, fits, plots, plots_su4, score_pulses  # noqa: F401

from .bloch import animate_bloch_ensemble, bloch_trajectories  # noqa: F401
from .fits import piecewise_linear_eval, segmented_linear_fit  # noqa: F401
from .plots import (  # noqa: F401
    fidelity_by_std,
    fidelity_contour_plot,
    fidelity_grid,
    mc_fidelity_estimate,
    plot_fidelity_by_std,
    plot_pulse_param,
)
from .score_pulses import (  # noqa: F401
    NAMED_SCORE_TARGETS,
    SCORE_ANGLE_VECTORS,
    build_score_pulses,
    score_n_config,
)
from .compare import compare_pulse_strategies  # noqa: F401
from .plots_su4 import (  # noqa: F401
    fidelity_by_std_su4,
    fidelity_contour_plot_su4,
    fidelity_grid_su4,
)
