from . import errors, objectives, propagate, su2, su4  # noqa: F401

from .errors import ore_ple_sampler, sample_ore, sample_ore_ple  # noqa: F401
from .objectives import (  # noqa: F401
    dcrab_fidelity,
    entanglement_fidelity,
    entanglement_fidelity_q,
    infidelity_loss,
    log_barrier,
    negative_log_loss,
    sharp_loss,
    trace_fidelity,
    trace_fidelity_q,
)
from .propagate import (  # noqa: F401
    propagate_assoc,
    propagate_mc,
    propagate_scan,
    propagate_scan_remat,
    propagate_unrolled,
    unitary_generator,
)
from .su2 import (  # noqa: F401
    axis_angle_to_quat,
    quat_conj,
    quat_fidelity,
    quat_identity,
    quat_multiply,
    quat_normalize,
    quat_to_su2,
    quat_trace_inner,
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
