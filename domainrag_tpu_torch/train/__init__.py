from . import checkpoint, flow_match, loop  # noqa: F401
