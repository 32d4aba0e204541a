from .loop import closed_loop_chunk, run_closed_loop
from .policies import make_policy

__all__ = ["make_policy", "closed_loop_chunk", "run_closed_loop"]
