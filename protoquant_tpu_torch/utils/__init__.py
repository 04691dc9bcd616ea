"""Configs and device resolution."""

from .config import EngineConfig, MeshConfig, ModelConfig
from .device import resolve_device

__all__ = ["EngineConfig", "MeshConfig", "ModelConfig", "resolve_device"]
