from . import fid  # noqa: F401
