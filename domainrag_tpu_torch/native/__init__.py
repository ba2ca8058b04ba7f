from .build import load_native, native_available  # noqa: F401
