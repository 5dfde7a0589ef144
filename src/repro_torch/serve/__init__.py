"""Batched serving on the port's models."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
