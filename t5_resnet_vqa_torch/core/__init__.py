"""Constants and device selection."""

from . import constants
from .device import resolve_device

__all__ = ["constants", "resolve_device"]
