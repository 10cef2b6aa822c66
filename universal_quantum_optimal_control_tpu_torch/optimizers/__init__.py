from . import dcrab  # noqa: F401
from .dcrab import DcrabConfig, dcrab_optimize  # noqa: F401
from .two_qubit_grape import named_two_qubit_targets  # noqa: F401
