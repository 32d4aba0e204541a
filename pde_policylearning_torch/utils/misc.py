"""Small utilities: parameter counts, seeding, a timer, energy spectra.

Counterpart of `pde_policylearning_tpu/utils/misc.py` (reference:
neuralop/utils.py:66 (count_params), libs/models/utils.py:123 (seeds),
:155-200 (timers), libs/parse_npy.py:26 (spectrum2 / spectrum3)).  Its
`apply_env_platform` (a JAX platform switch) has no counterpart.

The spectra bin 0.5 |fft(u) / s^d|^2 into radial shells: the shell of a
wavenumber vector is round(|k|) (half to even, as `jnp.round` and
`torch.round` both round), clipped to s - 1, and the bins are summed
with `index_add_`.  On the card `index_add_` adds with atomics, so the
order of a bin's sum, and its last bits, may change from run to run.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import numpy as np
import torch


def count_params(params) -> int:
    """The number of parameters of a module, or of the tensors and arrays
    of a (nested) dict or list (neuralop/utils.py:66)."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(math.prod(params.shape))


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy's global generator (libs/models/utils.py:123) and return
    a CPU `torch.Generator` seeded the same; the port draws from explicit
    generators, never torch's global one."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def timer(name: str = "", verbose: bool = True,
          results: Optional[dict] = None):
    """A wall-clock context timer (libs/models/utils.py:155-200), on the
    host's clock: synchronize the card inside the block to time its
    work."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    if verbose:
        print(f"[{name}] {dt * 1e3:.2f} ms")


def radial_shells(kmag: torch.Tensor, s: int) -> torch.Tensor:
    """The shell index of each wavenumber magnitude: round half to even,
    clipped to [0, s - 1]."""
    return torch.clamp(torch.round(kmag).long(), 0, s - 1)


def _spectrum(u, s: Optional[int], dims: int):
    u = torch.as_tensor(u)
    s = s or u.shape[-1]
    axes = tuple(range(-dims, 0))
    uh = torch.fft.fftn(u, dim=axes) / (s ** dims)
    energy = 0.5 * uh.abs() ** 2
    k = torch.fft.fftfreq(s, d=1.0 / s, dtype=energy.dtype, device=u.device)
    k2 = sum(k.reshape([-1 if a == i else 1 for a in range(dims)]) ** 2
             for i in range(dims))
    shells = radial_shells(torch.sqrt(k2), s).reshape(-1)
    flat = energy.reshape(*energy.shape[:-dims], -1)
    out = torch.zeros((*energy.shape[:-dims], s), dtype=energy.dtype,
                      device=u.device)
    return out.index_add_(-1, shells, flat)


def spectrum2(u, s: Optional[int] = None) -> torch.Tensor:
    """The radially binned 2-D kinetic-energy spectrum (parse_npy.py:26):
    u (..., s, s) -> (..., s), the energy in each wavenumber shell."""
    return _spectrum(u, s, 2)


def spectrum3(u, s: Optional[int] = None) -> torch.Tensor:
    """The radially binned 3-D energy spectrum (parse_npy.py spectrum3):
    u (..., s, s, s) -> (..., s)."""
    return _spectrum(u, s, 3)
