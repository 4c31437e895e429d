from . import synthetic  # noqa: F401
