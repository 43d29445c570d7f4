"""Serving on the port: the iCh-adaptive chunked-prefill `Engine`."""
from .engine import Engine, EngineConfig

__all__ = ["Engine", "EngineConfig"]
