from .su2_targets import build_su2_dataset, named_gate_rotation_vectors  # noqa: F401
from .su4_targets import (  # noqa: F401
    haar_su2,
    kak_decompose,
    kak_input_tokens,
    kak_targets,
    random_global_phase,
    z4_representatives,
)
