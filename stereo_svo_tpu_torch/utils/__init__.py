from . import checkpoint  # noqa: F401
