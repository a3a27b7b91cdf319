from .loader import NativeShardLoader, native_available  # noqa: F401

__all__ = ["NativeShardLoader", "native_available"]
