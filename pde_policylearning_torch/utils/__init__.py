from .device import resolve_device, set_solver_precision

__all__ = ["resolve_device", "set_solver_precision"]
