from . import config, coco, manifest, imaging  # noqa: F401
