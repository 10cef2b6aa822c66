from .su2_targets import build_su2_dataset, named_gate_rotation_vectors  # noqa: F401
