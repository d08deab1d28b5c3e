"""Light-transport models: the reference-tier eager integrator."""
from . import integrator

__all__ = ["integrator"]
