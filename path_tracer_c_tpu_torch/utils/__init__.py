"""Host-side utilities: image IO, config, metrics."""
from . import bitmap, config, metrics

__all__ = ["bitmap", "config", "metrics"]
