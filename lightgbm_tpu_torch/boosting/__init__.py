from .gbdt import GBDT, resolve_device

__all__ = ["GBDT", "resolve_device"]
