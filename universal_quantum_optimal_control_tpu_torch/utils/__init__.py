from .config import load_model_params  # noqa: F401
from .device import resolve_device  # noqa: F401
