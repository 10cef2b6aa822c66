from .propagate_su2 import (  # noqa: F401
    mean_fidelity_cuda,
    mean_fidelity_plain,
    propagate_mc_cuda,
    propagate_mc_plain,
    propagate_mc_vjp_cuda,
    propagate_mc_vjp_plain,
)
from .propagate_su4 import (  # noqa: F401
    mean_fidelity_su4_cuda,
    mean_fidelity_su4_plain,
    mean_fidelity_su4_with_product_cuda,
    mean_fidelity_su4_with_product_plain,
    propagate_su4_mc_cuda,
    propagate_su4_mc_plain,
    su4_objective_vjp_from_product_cuda,
    su4_objective_vjp_from_product_plain,
)
