"""Device selection, a bounded LRU cache and the experiment loggers."""

from .cache import BoundedCache
from .device import default_device, device_info, resolve_device
from .logging import EpochLogger, TsvLogger, colorize, statistics_scalar

__all__ = ["default_device", "device_info", "resolve_device",
           "BoundedCache", "EpochLogger", "TsvLogger", "colorize",
           "statistics_scalar"]
