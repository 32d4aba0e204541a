from .config import (DotDict, default_parser, load_yaml, merge_args_with_yaml,
                     parse_and_load, save_yaml)
from .device import resolve_device, set_solver_precision
from .logging import MetricsLogger

__all__ = ["resolve_device", "set_solver_precision", "DotDict",
           "default_parser", "load_yaml", "merge_args_with_yaml",
           "parse_and_load", "save_yaml", "MetricsLogger"]
