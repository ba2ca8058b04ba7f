from .orchestrator import PipelineRunner, build_tiny_runner  # noqa: F401
