"""Host rules of the two shared-memory kernels of csrc/common.cuh: how the
eigen-solve kernel (`eig_solve_tile_kernel`) cuts its work and its shared
memory for a grid, and how many rows a block of kernel A's plane pass
(`substage_planes_kernel`) owns.  `rk3_cuda.kernel_args` runs them once per
(grid, B) and hands the result to the C entries in `Dims`; the launchers
check it and decide nothing themselves.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MAX_DYNAMIC_SMEM = 232448   # bytes one block of an H100 can ask for
EIG_SMEM_BUDGET = MAX_DYNAMIC_SMEM - 1024   # less the kernel's static arrays
H100_SMS = 132
EIG_MAX_STAGES = 64         # kEigMaxStages in csrc/common.cuh
EIG_MAX_WARPS = 8           # kEigMaxWarps: a block has `EigPlan.warps` warps
EIG_COLS = 2                # kEigCols: columns a warp solves at a time


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(v: int, to: int) -> int:
    return _cdiv(v, to) * to


@dataclass(frozen=True)
class EigPlan:
    """Mirror of `struct EigPlan` (field order is the struct's).  tc > 0
    is the row-owned kernel (a block per tile of tc columns, `blocks` of
    them; of the rest only zero_blocks counts), tc = 0 the warp-owned one."""
    tc: int           # 0, or the row-owned kernel's tile width: 8 or 16
    rt: int           # output rows per lane: 4 or 5 (32 rt rows per sweep)
    slab: int         # contraction rows of one bulk copy: 32, 16 or 8
    stages: int       # slabs the ring holds
    resident: int     # 1: the ring holds both bases whole, read once
    blocks: int       # blocks on the column tiles
    zero_blocks: int  # blocks on the (0,0)-mode columns (0 and F of an env)
    warps: int        # warps of a block (each has 3 tiles)


def eig_tile_row(i: int) -> int:
    """Where row i of a warp's tile sits, in rows of two floats
    (`eig_tile_row` in csrc/common.cuh): one row of padding after every 8,
    so that the four neighbouring rows a lane stores after a product fall
    into different banks."""
    return i + (i >> 3)


def eig_tile_floats(n: int) -> int:
    """Floats of one (n, 2) tile: rows up to the next multiple of 8 (a
    product reads its right-hand side several rows at a time)."""
    return EIG_COLS * (eig_tile_row(_round_up(n, 8) - 1) + 1)


def eig_smem_bytes(n: int, K: int, plan: EigPlan) -> int:
    """Dynamic shared memory of one block of the warp-owned kernel
    (`eig_smem_bytes` in csrc/common.cuh): three n-vectors, the ring (rows
    padded to 4 floats, the basis to 8 rows) and three (n, 2) tiles for
    each warp."""
    Kp, Kq = _round_up(K, 8), _round_up(K, 4)
    ring = 2 * Kp * Kq if plan.resident else plan.stages * plan.slab * Kq
    return 4 * (3 * _round_up(n, 4) + ring
                + 3 * plan.warps * eig_tile_floats(n))


def eig_rows_smem_bytes(n: int, tc: int) -> int:
    """Shared memory of a block of the row-owned kernel: five (n, tc)
    tiles (`eig_rows_smem` in csrc/common.cuh)."""
    return 4 * 5 * n * tc


def eig_plan(n: int, K: int, B: int, F2: int, sms: int = H100_SMS) -> EigPlan:
    """The eigen-solve's plan for a basis of K contraction rows on the
    n-row spectra (F2 columns each) of B envs: which of its two kernels,
    and how that one cuts its work and its shared memory.

    The warp-owned kernel (resident basis, a warp per pair of columns)
    where a block's share of the B (F2 - 2) tile columns is at most one pair
    per warp (16 columns: B = 1 at 32x130x32), and where the other's tiles
    do not fit (Ny > 1453); the row-owned kernel for every other solve.
    Measured at 32x130x32 on an H100, device us per launch, warp-owned
    against row-owned at its better tile width: B = 1 31.1 / 39.5, B = 2
    51.3 / 43.0, B = 4 81.1 / 52.1, B = 8 142.8 / 95.9
    (`tools/kernel_routes.py`).

    Row-owned: tiles of 16 columns once they still make four blocks per SM
    and fit, else of 8; one block per (0,0)-mode column, an SM's worth at
    most.  Warp-owned:
    * zero_blocks: one block per (0,0)-mode column (two per env), at most an
      eighth of the SMs; blocks: one per SM that is left, fewer where that
      leaves a block under 8 columns.
    * rt: 4 rows per lane (128 per sweep over the basis), 5 where that takes
      fewer sweeps times rows (K = 129: one sweep of 160, not two of 128).
    * resident before streamed: the ring holds both bases if they fit beside
      the tiles of at least one warp; else it streams slabs of 32, 16 or 8
      rows through as many stages as fit beside the tiles (two wanted, one
      enough), with as many warps as leave room for that.
    * warps: as many as fit (8 at most), then as few as solve the busiest
      block's pairs in the same number of rounds.
    Raises ValueError where nothing fits."""
    columns = B * (F2 - 2)
    if n < 2 or K < 1 or columns < 1:
        raise ValueError(f"eig_plan: n = {n}, K = {K}, columns = {columns}")
    zero_blocks = min(2 * B, max(1, sms // 8))
    blocks = max(1, min(sms - zero_blocks, _cdiv(columns, 8)))
    per_block = _cdiv(columns, blocks)
    if per_block > EIG_COLS * EIG_MAX_WARPS \
            and eig_rows_smem_bytes(n, 8) <= MAX_DYNAMIC_SMEM:
        tc = 16 if (columns >= 16 * 4 * sms and
                    eig_rows_smem_bytes(n, 16) <= MAX_DYNAMIC_SMEM) else 8
        return EigPlan(tc, 0, 0, 0, 0, _cdiv(columns, tc), min(2 * B, sms), 0)
    rt = 5 if _cdiv(K, 160) * 5 < _cdiv(K, 128) * 4 else 4
    units = _cdiv(per_block, EIG_COLS)

    def plan(slab, stages, resident, fit):
        warps = _cdiv(units, _cdiv(units, fit))
        return EigPlan(0, rt, slab, stages, resident, blocks, zero_blocks,
                       warps)

    def fits(slab, stages, resident, warps):
        p = EigPlan(0, rt, slab, stages, resident, blocks, zero_blocks, warps)
        return eig_smem_bytes(n, K, p) <= EIG_SMEM_BUDGET

    stages = 2 * _cdiv(_round_up(K, 8), 32)
    if stages <= EIG_MAX_STAGES:
        for warps in range(EIG_MAX_WARPS, 0, -1):
            if fits(32, stages, 1, warps):
                return plan(32, stages, 1, warps)
    fallback = None
    for warps in range(EIG_MAX_WARPS, 0, -1):
        for slab in (32, 16, 8):
            stages = max((s for s in (1, 2) if fits(slab, s, 0, warps)),
                         default=0)
            while stages == 2 and stages < EIG_MAX_STAGES \
                    and fits(slab, stages + 1, 0, warps):
                stages += 1
            if stages >= 2:
                return plan(slab, stages, 0, warps)
            if stages == 1 and fallback is None:
                fallback = plan(slab, 1, 0, warps)
    if fallback is None:
        raise ValueError(
            f"the eigen-solve kernel cannot hold the tiles of one warp for "
            f"{n}-row spectra and a slab of a {K}-row basis in a block's "
            f"{EIG_SMEM_BUDGET} bytes of shared memory")
    return fallback


def substage_smem_bytes(rows: int, C: int) -> int:
    """Shared memory of one block of the plane pass: rows+2 planes of U and
    of W, rows+3 of V, and the new fields (rows, rows, rows+1)."""
    return 4 * (6 * rows + 8) * C


def substage_rows(B: int, Ny: int, C: int, sms: int = H100_SMS) -> int:
    """Interior rows a block of kernel A's plane pass owns; 0 sends the
    substage to the point-by-point pass.

    A plane (C = Nx Nz floats) must be a multiple of 16 bytes for the bulk
    copies, and the 14 planes of a one-row block must fit shared memory
    (C <= 4148, e.g. 64 x 64).  Two rows where they fit and still give every
    SM a block (B = 8 at 32x130x32: 520 blocks of 80 KB, two resident per
    SM, one loading while the other computes), else one (B = 1: 129 blocks
    for 132 SMs).  Measured there on an H100, device us per launch with 1,
    2, 4, 8 rows: B = 1 8.5, 11.7, 18.3, 34.6; B = 2 13.1, 12.3, 18.4, 34.8;
    B = 4 23.7, 19.7, 19.6, 35.4; B = 8 45.6, 37.9, 40.4, 45.4
    (`tools/kernel_routes.py`)."""
    if C % 4 or Ny < 3 or substage_smem_bytes(1, C) > MAX_DYNAMIC_SMEM:
        return 0
    if substage_smem_bytes(2, C) <= MAX_DYNAMIC_SMEM \
            and B * _cdiv(Ny - 1, 2) >= sms:
        return 2
    return 1


def plane_neighbours(Nx: int, Nz: int) -> torch.Tensor:
    """(6, Nx*Nz) int32: for plane column c = x*Nz + z its periodic x-, x+,
    z- and z+ neighbour columns and the two diagonal ones the stencils
    reach, x-(z+(c)) and z-(x+(c)): the table kernel A's plane pass reads
    (`Ops::nbr`) where the point-by-point kernels divide."""
    x = torch.arange(Nx).reshape(Nx, 1)
    z = torch.arange(Nz).reshape(1, Nz)
    xm, xp, zm, zp = (x - 1) % Nx, (x + 1) % Nx, (z - 1) % Nz, (z + 1) % Nz
    return torch.stack([xm * Nz + z, xp * Nz + z, x * Nz + zm, x * Nz + zp,
                        xm * Nz + zp, xp * Nz + zm]
                       ).reshape(6, Nx * Nz).to(torch.int32)


def padded_basis(a: torch.Tensor) -> torch.Tensor:
    """An eigenbasis matrix (K, K) as the eigen-solve kernels read it:
    transposed (contraction row k holds column k, so that a lane reads four
    neighbouring output rows as one float4) and padded with zeros to a
    multiple of 8 rows and of 4 columns: every row starts on 16 bytes and
    every slab a kernel copies is a multiple of 16 bytes."""
    K = a.shape[0]
    return torch.nn.functional.pad(a.T, (0, -K % 4, 0, -K % 8)).contiguous()


def padded_rows(a: torch.Tensor) -> torch.Tensor:
    """A matrix with its rows padded with zeros to a multiple of 4 floats
    (Pinv00: the (0,0)-mode blocks copy whole rows in bulk)."""
    return torch.nn.functional.pad(a, (0, -a.shape[1] % 4)).contiguous()


def reciprocals(a) -> np.ndarray:
    """The float32 nearest to 1 / float32(a), elementwise (IEEE division on
    the host): what `div_rn` in csrc/common.cuh multiplies by, then corrects
    twice by the residual, for the quotient in round-to-nearest."""
    a = np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32)
    return np.float32(1.0) / a

