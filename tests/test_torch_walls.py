"""The wall-pressure pair of csrc/common.cuh on the CPU: numpy emulations of
its two kernels, driven by the constants and the host rules the port really
makes, against the plain versions.

* Phase 1 (`boundary_planes_kernel`): the plane pass block by block (its
  rows, halo rows, clamped V rows and the Fv row a block computes again),
  in float64 with the terms of `plane_rhs_u/_v/_w` in the kernel's order,
  is exactly `cf.divergence(cf.compute_rhs(...))`.
* Phase 2 (`wall_solve_kernel`): the folded operator G (built and kept in
  float64) on float32 spectra with the kernel's summation order, the
  4-row (0,0) mode and the zeroed imaginary (0,0) column, against the
  float64 two-product route: no further from it than the float32
  two-product route (`boundary_solve_plain` in float32), and within 1e-5
  of that route on the developed state.  Rounded to float32, G alone
  would be further (`test_a_float32_operator_is_not_enough`).

Inputs are numpy arrays made from a seed."""
import functools

import numpy as np
import pytest
import torch

from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import rk3_cuda as rk
from pde_policylearning_torch.envs import tile_plan as tp
from pde_policylearning_torch.envs.control_env import default_snapshot_path
from test_torch_tiles import (_packed_inputs, _plane_rhs_u, _plane_rhs_v,
                              _plane_rhs_w, npa)


@functools.lru_cache(maxsize=None)
def grid_of(Nx, Ny, Nz, dtype=torch.float64):
    return cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, device="cpu",
                                dtype=dtype)


# ---------------------------------------------------------------------------
# Phase 1: the plane pass
# ---------------------------------------------------------------------------

def emulate_boundary_planes(grid, B, R, U, V, W, dPdx):
    """`boundary_planes_kernel` with R cell rows per block on packed numpy
    fields: per block the planes its bulk copies bring, Fu and Fw of its
    rows, Fv of its rows and of the row below, the divergence of each of
    its cell rows.  Returns (Y (n, B*C), write counts)."""
    Ny, C = grid.Ny, grid.Nx * grid.Nz
    n = Ny - 1
    sc = rk.solve_consts(grid)
    g = dict(nu=grid.nu, dx=grid.dx, dz=grid.dz, dx2=grid.dx ** 2,
             dz2=grid.dz ** 2, dyf=npa(sc.dyf), dyg=npa(sc.dyg),
             dym=npa(sc.dym))
    nbr = npa(tp.plane_neighbours(grid.Nx, grid.Nz))
    q = (np.arange(C), *nbr)
    Y = np.full((n, B * C), np.nan)
    cnt = np.zeros(Y.shape, int)
    per_env = -(-n // R)
    for block in range(B * per_env):
        b, blk = divmod(block, per_env)
        sl = slice(b * C, (b + 1) * C)
        i0 = 1 + blk * R
        i1 = min(Ny, i0 + R)
        v0, v1 = max(0, i0 - 2), min(i1, Ny - 1)
        Us = U[i0 - 1:i1 + 1, sl].copy()
        Ws = W[i0 - 1:i1 + 1, sl].copy()
        Vs = V[v0:v1 + 1, sl].copy()
        assert len(Us) == i1 - i0 + 2 and len(Vs) <= R + 3

        def rows(i):
            um = max(i - 1, i0 - 1) - (i0 - 1)
            uo = i - (i0 - 1)
            up = min(i + 1, i1) - (i0 - 1)
            return dict(um=Us[um], uo=Us[uo], up=Us[up], wm=Ws[um],
                        wo=Ws[uo], wp=Ws[up], vm=Vs[max(i - 1, v0) - v0],
                        vo=Vs[min(max(i, v0), v1) - v0],
                        vp=Vs[min(i + 1, v1) - v0])

        half_dP = dPdx[b] / 2.0
        Fv = [_plane_rhs_v(g, rows(i0 - 1), q, i0 - 1, i0 - 1 >= 1)]
        Fu, Fw = [], []
        for i in range(i0, i1):
            r = rows(i)
            Fu.append(_plane_rhs_u(g, r, q, half_dP, i, True))
            Fw.append(_plane_rhs_w(g, r, q, i, True))
            Fv.append(_plane_rhs_v(g, r, q, i, i <= Ny - 2))
        xp, zp = nbr[1], nbr[3]
        for rr, i in enumerate(range(i0, i1)):
            ux = (Fu[rr][xp] - Fu[rr]) / g["dx"]
            vy = (Fv[rr + 1] - Fv[rr]) / g["dyf"][i - 1]
            wz = (Fw[rr][zp] - Fw[rr]) / g["dz"]
            Y[i - 1, sl] = ux + vy + wz
            cnt[i - 1, sl] += 1
    return Y, cnt


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("shape", [(4, 9, 6), (8, 18, 4), (16, 33, 8),
                                   (2, 6, 2)])
def test_boundary_plane_pass_is_the_plain_pressure_rhs(shape, R, B):
    """Every cell row is written once and equals the plain pressure RHS
    exactly (the transform after it is the shared routine that
    tests/test_torch_transforms.py holds)."""
    grid = grid_of(*shape)
    f = _packed_inputs(grid, B, seed=sum(shape) * 10 + R + B)
    Y, cnt = emulate_boundary_planes(grid, B, R, f["U"], f["V"], f["W"],
                                     f["dPdx"])
    assert (cnt == 1).all()
    t = {k: torch.as_tensor(f[k]) for k in ("U", "V", "W", "dPdx")}
    Fu, Fv, Fw = cf.compute_rhs(
        grid, *(rk._unpack(t[k], grid, B) for k in "UVW"),
        t["dPdx"].reshape(B, 1, 1, 1))
    ref = rk._pack(cf.divergence(grid, Fu, Fv, Fw))
    np.testing.assert_array_equal(Y, npa(ref))


def test_boundary_rows_rule():
    C = 32 * 32
    assert tp.boundary_rows(1, 130, C) == 1          # 129 blocks, 132 SMs
    assert tp.boundary_rows(8, 130, C) == 2          # 520 blocks
    assert tp.boundary_rows(2, 130, C) == 1
    assert tp.boundary_rows(8, 130, C, fft=False) == 0   # the DFT route
    assert tp.boundary_rows(1, 130, 6 * 5) == 0      # no multiple of 16 bytes
    assert tp.boundary_rows(1, 2, C) == 0
    assert tp.boundary_rows(64, 130, 4148) == 1
    assert tp.boundary_rows(1, 130, 4152) == 0       # one row does not fit
    for B in (1, 2, 4, 8, 64):
        assert tp.boundary_rows(B, 130, C) == tp.substage_rows(B, 130, C)
    # the transform's arrays fit the room of the state planes they take
    from pde_policylearning_torch.envs import xz_fft
    for Nx, Nz in ((2, 2), (2, 64), (64, 2), (32, 32), (64, 64)):
        assert xz_fft.smem_bytes(Nx, Nz) <= 4 * 10 * Nx * Nz


# ---------------------------------------------------------------------------
# Phase 2: the folded wall solve
# ---------------------------------------------------------------------------

KWALL_SLICES = 8   # kWallSlices in csrc/common.cuh


def emulate_wall_solve(grid, t):
    """`wall_solve_kernel` on float32 spectra t (B, n, F2) -> q (B, 2, F2):
    per column eight slices of the contraction with G over s, each summed
    in s order in float64, the slices added in order; the Schur finish in
    float64 on the float32 constants; the (0,0) column from four rows of
    Pinv00 (lanes over k, then the butterfly) and the imaginary one
    zeroed; q rounded once to float32."""
    c = rk.solve_consts(grid)
    G = npa(c.G)
    g3, ss, s00 = (npa(a).astype(np.float64) for a in (c.g3, c.ss, c.s00))
    P4 = npa(c.Pinv00).astype(np.float64)
    dlm = float(c.dlm)
    t = t.astype(np.float32).astype(np.float64)
    B, n, F2 = t.shape
    m, F = n - 1, F2 // 2
    assert G.shape == (3, m, F2) and G.dtype == np.float64
    per = -(-m // KWALL_SLICES)
    y = None
    for sl in range(KWALL_SLICES):
        acc = np.zeros((B, 3, F2))
        for s in range(sl * per, min(m, sl * per + per)):
            acc = acc + G[None, :, s] * t[:, None, s]
        y = acc if y is None else y + acc
    last = (t[:, m] - dlm * y[:, 2]) / ss
    P = [y[:, k] - g3[k] * last for k in range(3)] + [last]
    for w, i in enumerate((0, 1, n - 2, n - 1)):
        lanes = np.zeros((B, 32))
        for k in range(n):
            lanes[:, k % 32] += P4[i, k] * (s00[k] * t[:, k, 0])
        o = 16
        while o:
            lanes = lanes + lanes[:, np.arange(32) ^ o]
            o >>= 1
        P[w][:, 0] = s00[i] * lanes[:, 0]
        P[w][:, F] = 0.0
    return np.stack([-0.5 * (P[0] + P[1]), -0.5 * (P[3] + P[2])],
                    1).astype(np.float32)


def _synth(grid, q):
    """q (B, 2, F2) -> p (2, B*C), the two planes' synthesis."""
    return rk.xz_inverse_plain(grid, torch.as_tensor(q))


def _wall_errors(shape, t64):
    """(folded kernel route, float32 two-product route) relative L2 errors
    of p against the float64 two-product route, and the distance between
    the two float32 routes."""
    g32, g64 = grid_of(*shape, dtype=torch.float32), grid_of(*shape)
    t32 = t64.astype(np.float32)
    exact = rk.boundary_solve_plain(g64, torch.as_tensor(t32).double())
    plain = rk.boundary_solve_plain(g32, torch.as_tensor(t32))
    fold = _synth(g32, emulate_wall_solve(g32, t32))

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm())
    return rel(fold, exact), rel(plain, exact), rel(fold, plain)


def _random_state_t(shape, B, seed):
    """A pressure RHS spectrum of a random state (float64)."""
    grid = grid_of(*shape)
    f = _packed_inputs(grid, B, seed)
    return npa(rk.boundary_fwd_plain(grid, *(torch.as_tensor(f[k]) for k in
                                             ("U", "V", "W", "dPdx"))))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("shape", [(2, 6, 2), (3, 9, 4), (8, 18, 4),
                                   (8, 33, 8), (4, 18, 6), (16, 65, 8),
                                   (24, 18, 20)])
def test_folded_wall_solve_against_float64(shape, B):
    """On random states: no further from the float64 solve than the float32
    two-product route, but where both sit at the floor that the float32
    constants and spectrum they share set (under 1e-6 on these grids)."""
    e_fold, e_plain, _ = _wall_errors(shape, _random_state_t(shape, B,
                                                          seed=B + shape[1]))
    assert e_fold <= e_plain or e_fold < 1e-6, (e_fold, e_plain)


def _snapshot_t():
    """The first observation's pressure RHS spectrum at 32x130x32 on the
    packaged Re_tau ~ 180 snapshot (float64)."""
    g64 = grid_of(32, 130, 32)
    snap = np.load(default_snapshot_path())
    st = rk.state_to_kstate(cf.init_state(
        g64, U=snap["U"], V=snap["V"], W=snap["W"],
        dPdx=float(snap["dPdx"])))
    return npa(rk.boundary_fwd_plain(g64, st.U, st.V, st.W,
                                     st.dPdx.reshape(1)))


def test_folded_wall_solve_on_the_snapshot():
    e_fold, e_plain, e_between = _wall_errors((32, 130, 32), _snapshot_t())
    assert e_fold <= e_plain, (e_fold, e_plain)
    assert e_between <= 1e-5, e_between


@pytest.mark.parametrize("shape,B", [((8, 33, 8), 1), ((16, 65, 8), 2),
                                     ((32, 130, 32), 1)])
def test_a_float32_operator_is_not_enough(shape, B):
    """Why G stays in float64: on a random state's spectrum (white noise
    cancels in sum_s G t), G rounded to float32, with exact sums after it,
    puts the wall rows of the block solve further from float64 than the
    float32 two-product route is (kept in float64 it sits at the floor the
    float32 constants set, beside that route)."""
    g32, g64 = grid_of(*shape, dtype=torch.float32), grid_of(*shape)
    c32, c64 = rk.solve_consts(g32), rk.solve_consts(g64)
    m = shape[1] - 2
    t = torch.as_tensor(_random_state_t(shape, B, seed=B + shape[1])
                        .astype(np.float32))
    T = t.double()[:, :m]
    exact = c64.A13 @ ((c64.B1 @ T) / c64.denom1)
    two = (c32.A13 @ ((c32.B1 @ t[:, :m]) / c32.denom1)).double()
    fold32 = torch.einsum("ksj,bsj->bkj", c32.G.float().double(), T)
    fold64 = torch.einsum("ksj,bsj->bkj", c32.G, T)

    def err(a):
        return float((a - exact).norm() / exact.norm())
    assert max(err(fold64), err(two)) < err(fold32)


@pytest.mark.parametrize("shape", [(8, 33, 8), (32, 130, 32)])
def test_folded_operator_is_the_three_block_rows(shape):
    """G[:, :, j] = A13 diag(1 / denom1[:, j]) B1, in float64, column by
    column; a float32 grid's G is that of its float32 constants, made and
    kept in float64."""
    grid = grid_of(*shape)
    c = rk.solve_consts(grid)
    G = c.G
    m, F2 = grid.Ny - 2, 2 * grid.Nx * (grid.Nz // 2 + 1)
    assert G.shape == (3, m, F2) and G.dtype == torch.float64
    for j in (0, 1, F2 // 2, F2 - 1, F2 // 3):
        ref = c.A13 @ torch.diag(1.0 / c.denom1[:, j]) @ c.B1
        torch.testing.assert_close(G[:, :, j], ref, rtol=1e-12,
                                   atol=1e-12 * float(ref.abs().max()))
    c32 = rk.solve_consts(grid_of(*shape, dtype=torch.float32))
    assert c32.G.dtype == torch.float64
    ref = torch.einsum("kr,rs,rj->ksj", c32.A13.double(), c32.B1.double(),
                       1.0 / c32.denom1.double())
    torch.testing.assert_close(c32.G, ref, rtol=1e-12,
                               atol=1e-12 * float(ref.abs().max()))
    # the block rows the kernel reads: rows 0, 1, m-1 of A1
    assert torch.equal(c.A13, c.A1[[0, 1, m - 1]])
