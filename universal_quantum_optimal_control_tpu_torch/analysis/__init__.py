from .plots import mc_fidelity_estimate  # noqa: F401
