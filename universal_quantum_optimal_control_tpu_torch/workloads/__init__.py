"""Command-line entry points of the port (``python -m
universal_quantum_optimal_control_tpu_torch.workloads.<name>``)."""
