"""Model artifacts of the port."""
from .gbdt import GBDTBooster

__all__ = ["GBDTBooster"]
