from . import errors, objectives, propagate, su2, su4  # noqa: F401

from .errors import sample_ore_ple  # noqa: F401
from .propagate import propagate_mc, propagate_scan  # noqa: F401
from .su2 import (  # noqa: F401
    axis_angle_to_quat,
    quat_conj,
    quat_fidelity,
    quat_multiply,
    quat_normalize,
    quat_to_su2,
    rotation_vector_to_quat,
    segment_quat,
    segment_quat_amp,
    segment_quat_det,
    su2_to_quat,
)
from .su4 import (  # noqa: F401
    TwoQubitSystem,
    fidelity_su4_ri,
    propagate_su4,
    propagate_su4_mc,
)
