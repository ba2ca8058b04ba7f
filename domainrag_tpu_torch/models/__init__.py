from . import clip, common, resnet_stem  # noqa: F401
