from .su2_targets import named_gate_rotation_vectors  # noqa: F401
