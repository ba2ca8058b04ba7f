from . import collectives, deploy, mesh, sharding  # noqa: F401
