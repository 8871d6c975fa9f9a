"""Optimizers of the port."""
from . import adamw

__all__ = ["adamw"]
