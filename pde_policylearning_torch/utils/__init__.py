from .config import (DotDict, default_parser, load_yaml, merge_args_with_yaml,
                     parse_and_load, save_yaml)
from .device import resolve_device, set_solver_precision
from .logging import MetricsLogger
from .misc import count_params, set_seed, spectrum2, spectrum3, timer
from .profiling import (benchmark, flop_estimate, memory_summary,
                        profile_result, trace)
from .visualization import (matrix2image, save_images_to_video, vis_diagram,
                            visualize_pressure_speed)

__all__ = ["resolve_device", "set_solver_precision", "DotDict",
           "default_parser", "load_yaml", "merge_args_with_yaml",
           "parse_and_load", "save_yaml", "MetricsLogger",
           "count_params", "set_seed", "spectrum2", "spectrum3", "timer",
           "benchmark", "flop_estimate", "memory_summary", "profile_result",
           "trace", "matrix2image", "save_images_to_video", "vis_diagram",
           "visualize_pressure_speed"]
