from . import topk  # noqa: F401
