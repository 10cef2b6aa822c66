from .su2_targets import build_su2_dataset, named_gate_rotation_vectors  # noqa: F401
from .su4_targets import (  # noqa: F401
    kak_decompose,
    kak_input_tokens,
    z4_representatives,
)
