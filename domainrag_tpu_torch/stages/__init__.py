from . import encoders, retrieve  # noqa: F401
