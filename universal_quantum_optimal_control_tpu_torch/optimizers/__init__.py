from .two_qubit_grape import named_two_qubit_targets  # noqa: F401
