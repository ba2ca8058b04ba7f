from . import scheduler  # noqa: F401
