"""The YAML config system: the port's own copy of the JAX package's
``config/`` (the registry and the object-graph loader) on its own YAML reader."""

from .registry import REGISTRY, register, resolve_path
from .yaml_config import load_config, parse_arguments

__all__ = ["register", "resolve_path", "REGISTRY", "load_config", "parse_arguments"]
