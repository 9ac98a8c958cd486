"""Device selection."""

from .device import default_device, device_info, resolve_device

__all__ = ["default_device", "device_info", "resolve_device"]
