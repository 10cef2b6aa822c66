from . import app  # noqa: F401
