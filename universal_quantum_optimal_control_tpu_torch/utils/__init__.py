from . import config  # noqa: F401

from .config import RunConfig, load_model_params, load_run_config  # noqa: F401
from .device import resolve_device  # noqa: F401
