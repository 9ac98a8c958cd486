"""Device selection, a bounded LRU cache, the experiment loggers,
checkpoints, experiment grids, profiling and artifact provenance."""

from .cache import BoundedCache
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .device import default_device, device_info, resolve_device
from .experiment import (DEFAULT_DATA_DIR, ExperimentGrid,
                         setup_logger_kwargs)
from .logging import EpochLogger, TsvLogger, colorize, statistics_scalar
from .profiling import ThroughputTimer, device_roofline, trace
from .provenance import kernel_source_hash, source_file_hash

__all__ = ["default_device", "device_info", "resolve_device",
           "BoundedCache", "EpochLogger", "TsvLogger", "colorize",
           "statistics_scalar", "save_checkpoint", "restore_checkpoint",
           "latest_step", "DEFAULT_DATA_DIR", "ExperimentGrid",
           "setup_logger_kwargs", "ThroughputTimer", "device_roofline",
           "trace", "kernel_source_hash", "source_file_hash"]
