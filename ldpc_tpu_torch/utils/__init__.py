"""Device selection, a bounded LRU cache, the experiment loggers,
checkpoints and experiment grids."""

from .cache import BoundedCache
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .device import default_device, device_info, resolve_device
from .experiment import ExperimentGrid, setup_logger_kwargs
from .logging import EpochLogger, TsvLogger, colorize, statistics_scalar

__all__ = ["default_device", "device_info", "resolve_device",
           "BoundedCache", "EpochLogger", "TsvLogger", "colorize",
           "statistics_scalar", "save_checkpoint", "restore_checkpoint",
           "latest_step", "ExperimentGrid", "setup_logger_kwargs"]
