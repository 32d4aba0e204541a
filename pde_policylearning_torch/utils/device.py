"""Device selection and solver precision for the PyTorch port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Turn a device spec into a `torch.device`.

    ``None`` means the card (``cuda``): the port's entry points run there
    unless the caller asks for the CPU by name.  Asking for CUDA, by name
    or by default, on a machine without a usable card raises: the port
    never moves work to the CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


def set_solver_precision() -> None:
    """Keep float32 products in full fp32.

    TF32 keeps about three decimal digits; at that precision the channel
    solver's eigen-solve error NaNs the DNS within a few hundred steps
    (the JAX package's `channel_flow._SOLVE_PREC` note).  The port's own
    kernels use fp32 FMA and never TF32; this covers the torch products of
    the plain versions and the glue around the kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
