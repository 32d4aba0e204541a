"""Build `csrc/*.cu` with nvcc into one shared library and load it with
ctypes.

The library is built at first use into `build/kernels/` at the repository
root, named by a hash of the sources and flags, so an edit to any source
triggers a rebuild and an unchanged tree reuses the file.  Each source
compiles in its own nvcc process, all started together, and one more nvcc
links the objects.  There is no fallback: without nvcc, loading raises.

Every C entry returns its `cudaError_t` (0 on success); `check` raises on
anything else.  Pointers and the stream pass as `c_void_p`, the structs
below by pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # used when nvcc is not on PATH
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: the stencils round term by term as the plain torch versions
# do (csrc/common.cuh); the GEMMs call fmaf explicitly.
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p


class EigPlan(ctypes.Structure):
    """Mirror of `struct EigPlan` in csrc/common.cuh (and of
    `tile_plan.EigPlan`, which makes it)."""
    _fields_ = [(k, ctypes.c_int) for k in (
        "tc", "rt", "slab", "stages", "resident", "blocks", "zero_blocks",
        "warps", "lean")]


class Dims(ctypes.Structure):
    """Mirror of `struct Dims` in csrc/common.cuh.  rdx .. rdz2 are the
    float32 reciprocals of the float32 dx .. dz2; `sub_rows`, `bnd_rows`
    and `eig` (the full basis' plan, then the bordered one's) are the host
    rules of `envs/tile_plan.py`."""
    _fields_ = [("B", ctypes.c_int), ("Nx", ctypes.c_int),
                ("Ny", ctypes.c_int), ("Nz", ctypes.c_int),
                ("refine_steps", ctypes.c_int),
                ("nu", ctypes.c_float), ("dx", ctypes.c_float),
                ("dz", ctypes.c_float), ("dt", ctypes.c_float),
                ("dlm", ctypes.c_float), ("dd0h", ctypes.c_float),
                ("dx2", ctypes.c_float), ("dz2", ctypes.c_float),
                ("rdx", ctypes.c_float), ("rdz", ctypes.c_float),
                ("rdx2", ctypes.c_float), ("rdz2", ctypes.c_float),
                ("sub_rows", ctypes.c_int), ("bnd_rows", ctypes.c_int),
                ("eig", EigPlan * 2)]


class Ops(ctypes.Structure):
    """Mirror of `struct Ops`: device pointers to the cached constants.
    rdyf, rdyg, rdym are the float32 reciprocals of dyf, dyg, dym.  T2 and
    Ti2 are null on a grid whose x/z transforms run as FFTs, the twiddle
    tables twx and twz on any other; Pinv00's rows are padded to 4 floats,
    Pinv4 holds its rows 0, 1, n-2, n-1; G is the wall solve's folded
    operator in float64 (`rk3_cuda.SolveConsts.G`); nbr is the table of a
    plane's periodic neighbour columns; the last four are the transposed,
    padded bases the eigen-solve kernels read."""
    _fields_ = [(k, _P) for k in (
        "dyf", "dyg", "dym", "rdyf", "rdyg", "rdym", "trapw", "T2", "Ti2",
        "denom1", "g", "ss", "kk", "g3", "denom", "Pinv00", "Pinv4", "s00",
        "dd", "dl", "du", "G", "twx", "twz", "nbr", "A1T", "B1T", "AT",
        "BfT")]


class Work(ctypes.Structure):
    """Mirror of `struct Work`: device pointers to the scratch workspace and
    the size (in floats) of its split-product buffer `part`."""
    _fields_ = [(k, _P) for k in (
        "Fu", "Fv", "Fw", "F1u", "F1v", "F1w", "Un", "Vn", "Wn", "Y", "t",
        "P", "p", "q", "dnew", "part")] + [
        ("part_cap", ctypes.c_longlong)]


class CornerDims(ctypes.Structure):
    """Mirror of `struct CornerDims` in csrc/corner_contract.cu: the shape,
    the element strides of the x and w operands, and the signs of their
    imaginary parts."""
    _fields_ = [(k, ctypes.c_int) for k in ("R", "B", "M2", "I", "O")] + [
        ("xs", ctypes.c_longlong * 4), ("ws", ctypes.c_longlong * 4),
        ("sgn_xi", ctypes.c_float), ("sgn_wi", ctypes.c_float)]


class SpectralDims(ctypes.Structure):
    """Mirror of `struct SpectralDims` in csrc/corner_contract.cu: the
    spectrum's shape, the corner sizes, the element strides of each
    corner's weights over (kx, ky, in, out) and the sign of their imaginary
    parts."""
    _fields_ = [(k, ctypes.c_int) for k in ("B", "H", "Wh", "I", "O", "m1",
                                            "m2")] + [
        ("ws", (ctypes.c_longlong * 4) * 2), ("sgn_wi", ctypes.c_float)]


class CornerDwDims(ctypes.Structure):
    """Mirror of `struct CornerDwDims` in csrc/corner_contract.cu: the two
    spectra's shape, the corner sizes, which corners' weight gradients to
    write, and each spectrum's complex element strides over (b, h, ky,
    channel)."""
    _fields_ = [(k, ctypes.c_int) for k in ("B", "H", "Wh", "I", "O", "m1",
                                            "m2")] + [
        ("want", ctypes.c_int * 2), ("xs", ctypes.c_longlong * 4),
        ("ds", ctypes.c_longlong * 4)]


_ENTRIES = {
    # dims, ops, work, Y, out, stream
    "pde_poisson_solve": [_P, _P, _P, _P, _P, _P],
    # dims, ops, work, phases, U, V, W, dPdx, t, p, stream
    "pde_boundary_pressures": [_P, _P, _P, ctypes.c_int] + [_P] * 7,
    # dims, ops, work, U, V, W, op1, op2, dPdx, meanU0,
    # Uo, Vo, Wo, dPdx_out, p, stream
    "pde_rk3_fullstep": [_P] * 16,
    # dims, ops, work, U, V, W, U0, V0, W0, F1u, F1v, F1w, op1, op2, dPdx,
    # a, bp, out_f, Un, Vn, Wn, div, Fu, Fv, Fw, stream
    "pde_rk3_substage": [_P] * 15 + [ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int] + [_P] * 8,
    # dims, ops, work, div, Un, Vn, Wn, op1, op2, Uo, Vo, Wo, stream
    "pde_rk3_solve_correct": [_P] * 13,
    # dims, ops, work, U (updated in place), meanU0, dPdx, dPdx_out, stream
    "pde_rk3_massflow": [_P] * 8,
    # corner dims, xr, xi, wr, wi, outr, outi, stream
    "pde_corner_contract": [_P] * 8,
    # spectral dims, x_ft, wr low, wi low, wr high, wi high, out_ft, stream
    "pde_spectral_corners": [_P] * 8,
    # dw dims, x_ft, dout, dw low, dw high, stream
    "pde_spectral_corners_dw": [_P] * 6,
    # dims, ops, work, Y, rows, t, stream / dims, ops, work, P, rows, out,
    # stream
    "pde_xz_forward": [_P, _P, _P, _P, ctypes.c_int, _P, _P],
    "pde_xz_inverse": [_P, _P, _P, _P, ctypes.c_int, _P, _P],
}

_lib = None
build_log = ""
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(NVCC_DEFAULT):
        nvcc = NVCC_DEFAULT
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of pde_policylearning_torch "
            "are built from csrc/ at first use and need the CUDA toolkit "
            "(nvcc on PATH or /usr/local/cuda/bin/nvcc)")
    return nvcc


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpde_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for this source tree
    exists; returns its path.  nvcc's output (ptxas' registers and spills
    among it) is kept beside the library and read back into `build_log`
    when the library is reused."""
    global build_log, build_seconds
    so = library_path()
    if so.exists():
        log = so.with_suffix(".log")
        build_log = log.read_text() if log.exists() else ""
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [f"{tmp}/{f.stem}.o" for f in cu]
        procs = [_start([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(f)])
                 for f, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        if all(p.returncode == 0 for p in procs):
            procs.append(_start([nvcc, *GENCODE, "-shared", "-o",
                                 f"{tmp}/lib.so", *objs]))
            logs.append(procs[-1].communicate()[0])
        build_log = "".join(logs)
        build_seconds = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        so.with_suffix(".log").write_text(build_log)
        os.replace(f"{tmp}/lib.so", so)
    return so


def _start(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pde_error_string.argtypes = [ctypes.c_int]
        lib.pde_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = load().pde_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_cuda_f32(name, a, shape, contiguous=True):
    """Raise unless `a` is a float32 CUDA tensor of `shape` (and, where the
    kernel reads it in place, contiguous) that needs no gradient.

    A kernel writes a fresh buffer, so a gradient would be lost without a
    word; the differentiable entries (`channel_flow.poisson_solve`,
    `boundary_pressures`, `rk3_step`, `env_step`,
    `spectral_cuda.corner_contract`, `spectral_corners`) call the kernels
    inside autograd
    Functions, where grad mode is off."""
    if torch.is_grad_enabled() and a.requires_grad:
        raise RuntimeError(
            f"{name}: a CUDA kernel passes no gradient; detach the input or "
            "use the differentiable entry (channel_flow.poisson_solve, "
            "boundary_pressures, rk3_step, env_step; "
            "spectral_cuda.corner_contract, spectral_corners)")
    if not a.is_cuda or a.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes float32 CUDA "
                         f"tensors, got {a.dtype} on {a.device}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(a.shape)}")
    if contiguous and not a.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
