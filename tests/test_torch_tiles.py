"""The shared-memory kernels of the channel-flow step on the CPU: numpy
emulations (float64, kept here beside their only callers) of the index
arithmetic and the summation order of kernel A's plane pass
(`substage_planes_kernel`), of the two eigen-solve kernels
(`eig_solve_tile_kernel`, `eig_solve_rows_kernel`) and of the (0,0)-mode
blocks (`eig_zero_mode`) of csrc/common.cuh, driven by the plans and the
padded constants the host really makes (`envs/tile_plan.py`), against the
plain versions; the host rules themselves; and the ctypes mirrors against
the structs' text.  Inputs are numpy arrays made from a seed."""
import ctypes
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import poisson_cuda as pc
from pde_policylearning_torch.envs import rk3_cuda as rk
from pde_policylearning_torch.envs import tile_plan as tp
from pde_policylearning_torch.native import cuda_build


@functools.lru_cache(maxsize=None)
def grid64(Nx, Ny, Nz, refine=0):
    return cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, device="cpu",
                                dtype=torch.float64, refine_steps=refine)


def npa(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Kernel A on whole x-z planes: `substage_planes_kernel`, block by block,
# with the plane rows a block copies into shared memory as local arrays,
# the clamped row pointers, the neighbour table and the terms of
# plane_rhs_u / _v / _w in the kernel's order.
# ---------------------------------------------------------------------------

def _plane_rhs_u(g, r, q, half_dP, i, yint):
    c, xm, xp, zm, zp, xmzp, _ = q
    uc, uxp, uxm, uzp, uzm = (r["uo"][k] for k in (c, xp, xm, zp, zm))
    f = -((0.5 * (uc + uxp)) ** 2 - (0.5 * (uxm + uc)) ** 2) / g["dx"]
    if yint:
        uv1 = (0.5 * (r["vo"][c] + r["vo"][xm])) * (0.5 * (uc + r["up"][c]))
        uv0 = (0.5 * (r["vm"][c] + r["vm"][xm])) * (0.5 * (r["um"][c] + uc))
        f = f - (uv1 - uv0) / g["dyf"][i - 1]
    uw1 = (0.5 * (r["wo"][zp] + r["wo"][xmzp])) * (0.5 * (uzp + uc))
    uw0 = (0.5 * (r["wo"][c] + r["wo"][xm])) * (0.5 * (uc + uzm))
    f = f - (uw1 - uw0) / g["dz"]
    f = f + g["nu"] * (uxp - 2.0 * uc + uxm) / g["dx2"]
    if yint:
        du1 = (r["up"][c] - uc) / g["dyg"][i]
        du0 = (uc - r["um"][c]) / g["dyg"][i - 1]
        f = f + g["nu"] * (du1 - du0) / g["dyf"][i - 1]
    f = f + g["nu"] * (uzp - 2.0 * uc + uzm) / g["dz2"]
    return f + half_dP


def _plane_rhs_v(g, r, q, i, yint):
    c, xm, xp, zm, zp, _, _ = q
    vc, vxp, vxm, vzp, vzm = (r["vo"][k] for k in (c, xp, xm, zp, zm))
    uv1 = (0.5 * (vxp + vc)) * (0.5 * (r["uo"][xp] + r["up"][xp]))
    uv0 = (0.5 * (vc + vxm)) * (0.5 * (r["uo"][c] + r["up"][c]))
    f = -(uv1 - uv0) / g["dx"]
    if yint:
        vv1 = (0.5 * (vc + r["vp"][c])) ** 2
        vv0 = (0.5 * (r["vm"][c] + vc)) ** 2
        f = f - (vv1 - vv0) / g["dym"][i - 1]
    vw1 = (0.5 * (vzp + vc)) * (0.5 * (r["wo"][zp] + r["wp"][zp]))
    vw0 = (0.5 * (vc + vzm)) * (0.5 * (r["wo"][c] + r["wp"][c]))
    f = f - (vw1 - vw0) / g["dz"]
    f = f + g["nu"] * (vxp - 2.0 * vc + vxm) / g["dx2"]
    if yint:
        dv1 = (r["vp"][c] - vc) / g["dyf"][i]
        dv0 = (vc - r["vm"][c]) / g["dyf"][i - 1]
        f = f + g["nu"] * (dv1 - dv0) / g["dym"][i - 1]
    f = f + g["nu"] * (vzp - 2.0 * vc + vzm) / g["dz2"]
    return f


def _plane_rhs_w(g, r, q, i, yint):
    c, xm, xp, zm, zp, _, zmxp = q
    wc, wxp, wxm, wzp, wzm = (r["wo"][k] for k in (c, xp, xm, zp, zm))
    uw1 = (0.5 * (wxp + wc)) * (0.5 * (r["uo"][xp] + r["uo"][zmxp]))
    uw0 = (0.5 * (wc + wxm)) * (0.5 * (r["uo"][c] + r["uo"][zm]))
    f = -(uw1 - uw0) / g["dx"]
    if yint:
        vw1 = (0.5 * (r["vo"][c] + r["vo"][zm])) * (0.5 * (wc + r["wp"][c]))
        vw0 = (0.5 * (r["vm"][c] + r["vm"][zm])) * (0.5 * (r["wm"][c] + wc))
        f = f - (vw1 - vw0) / g["dyf"][i - 1]
    f = f - ((0.5 * (wc + wzp)) ** 2 - (0.5 * (wzm + wc)) ** 2) / g["dz"]
    f = f + g["nu"] * (wxp - 2.0 * wc + wxm) / g["dx2"]
    if yint:
        dw1 = (r["wp"][c] - wc) / g["dyg"][i]
        dw0 = (wc - r["wm"][c]) / g["dyg"][i - 1]
        f = f + g["nu"] * (dw1 - dw0) / g["dyf"][i - 1]
    f = f + g["nu"] * (wzp - 2.0 * wc + wzm) / g["dz2"]
    return f


def emulate_planes(grid, B, R, U, V, W, U0, V0, W0, F1, op1, op2, dPdx, a,
                   bp, out_f):
    """`substage_planes_kernel` with R rows per block on packed numpy
    fields.  Returns ({name: array}, {name: write counts})."""
    Ny, C = grid.Ny, grid.Nx * grid.Nz
    sc = rk.solve_consts(grid)
    g = dict(nu=grid.nu, dx=grid.dx, dz=grid.dz, dx2=grid.dx ** 2,
             dz2=grid.dz ** 2, dyf=npa(sc.dyf), dyg=npa(sc.dyg),
             dym=npa(sc.dym))
    nbr = npa(tp.plane_neighbours(grid.Nx, grid.Nz))
    cols = np.arange(C)
    q = (cols, *nbr)
    shapes = dict(Un=U.shape, Vn=V.shape, Wn=W.shape, div=(Ny - 1, B * C),
                  Fu=U.shape, Fv=V.shape, Fw=W.shape)
    out = {k: np.full(s, np.nan) for k, s in shapes.items()}
    cnt = {k: np.zeros(s, int) for k, s in shapes.items()}
    use_prev = bp != 0.0

    def put(name, row, b, val):
        out[name][row, b * C:(b + 1) * C] = val
        cnt[name][row, b * C:(b + 1) * C] += 1

    per_env = -(-(Ny - 1) // R)
    for block in range(B * per_env):
        b, blk = divmod(block, per_env)
        sl = slice(b * C, (b + 1) * C)
        i0 = 1 + blk * R
        i1 = min(Ny, i0 + R)
        Rr = i1 - i0
        v0, v1 = max(0, i0 - 2), min(i1, Ny - 1)
        # what the bulk copies bring: rows i0-1 .. i1 of U and W, v0 .. v1
        # of V
        Us = U[i0 - 1:i1 + 1, sl].copy()
        Ws = W[i0 - 1:i1 + 1, sl].copy()
        Vs = V[v0:v1 + 1, sl].copy()
        Uns, Wns = np.zeros((R, C)), np.zeros((R, C))
        Vns = np.zeros((R + 1, C))
        half_dP = dPdx[b] / 2.0

        def rows(i):
            um = max(i - 1, i0 - 1) - (i0 - 1)
            uo = i - (i0 - 1)
            up = min(i + 1, i1) - (i0 - 1)
            return dict(um=Us[um], uo=Us[uo], up=Us[up], wm=Ws[um],
                        wo=Ws[uo], wp=Ws[up], vm=Vs[max(i - 1, v0) - v0],
                        vo=Vs[min(max(i, v0), v1) - v0],
                        vp=Vs[min(i + 1, v1) - v0])

        def v_point(r, i, own):
            wall = i == 0 or i == Ny - 1
            fv = (_plane_rhs_v(g, r, q, i, 1 <= i <= Ny - 2)
                  if (out_f and own) or not wall else 0.0)
            if out_f and own:
                put("Fv", i, b, fv)
            if i == 0:
                v = op1[0, sl]
            elif i == Ny - 1:
                v = op2[0, sl]
            else:
                v = V0[i, sl] + a * fv
                if use_prev:
                    v = v + bp * F1[1][i, sl]
            if own:
                put("Vn", i, b, v)
            Vns[i - (i0 - 1)] = v

        v_point(rows(i0 - 1), i0 - 1, i0 == 1)
        for rr in range(Rr):
            i = i0 + rr
            r = rows(i)
            fu = _plane_rhs_u(g, r, q, half_dP, i, True)
            fw = _plane_rhs_w(g, r, q, i, True)
            if out_f:
                put("Fu", i, b, fu)
                put("Fw", i, b, fw)
            u = U0[i, sl] + a * fu
            w = W0[i, sl] + a * fw
            if use_prev:
                u = u + bp * F1[0][i, sl]
                w = w + bp * F1[2][i, sl]
            put("Un", i, b, u)
            put("Wn", i, b, w)
            v_point(r, i, True)
            Uns[rr], Wns[rr] = u, w
            for ig in ([0] if i == 1 else []) + ([Ny] if i == Ny - 1 else []):
                put("Un", ig, b, -1.0 * u)
                put("Wn", ig, b, -1.0 * w)
                if out_f:
                    rg = rows(ig)
                    put("Fu", ig, b, _plane_rhs_u(g, rg, q, half_dP, ig,
                                                  False))
                    put("Fw", ig, b, _plane_rhs_w(g, rg, q, ig, False))
        xp, zp = nbr[1], nbr[3]
        for rr in range(Rr):
            i = i0 + rr
            ux = (Uns[rr][xp] - Uns[rr]) / g["dx"]
            vy = (Vns[rr + 1] - Vns[rr]) / g["dyf"][i - 1]
            wz = (Wns[rr][zp] - Wns[rr]) / g["dz"]
            put("div", i - 1, b, ux + vy + wz)
    return out, cnt


def _packed_inputs(grid, B, seed):
    rng = np.random.default_rng(seed)
    Ny, BC = grid.Ny, B * grid.Nx * grid.Nz
    f = {k: rng.standard_normal((rows, BC)) for k, rows in dict(
        U=Ny + 1, V=Ny, W=Ny + 1, U0=Ny + 1, V0=Ny, W0=Ny + 1, F1u=Ny + 1,
        F1v=Ny, F1w=Ny + 1, op1=1, op2=1).items()}
    f["dPdx"] = rng.standard_normal(B)
    return f


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("Ny", [9, 18, 33, 130])
@pytest.mark.parametrize("stage,out_f", [(0, True), (0, False), (1, True),
                                         (1, False), (2, True), (2, False)])
def test_plane_tiling_reproduces_substage_plain(Ny, R, B, stage, out_f):
    """Every block's rows, halo rows, ghost rows and its overlapping V row:
    each output point of kernel A is written once and equals the plain
    version's exactly, the divergence included."""
    grid = grid64(4, Ny, 6)
    f = _packed_inputs(grid, B, seed=Ny * 100 + R * 10 + B)
    c_cur, c_prev = rk._RK3_STAGES[stage]
    a, bp = grid.dt * c_cur, grid.dt * c_prev
    F1 = (f["F1u"], f["F1v"], f["F1w"])
    out, cnt = emulate_planes(grid, B, R, f["U"], f["V"], f["W"], f["U0"],
                              f["V0"], f["W0"], F1, f["op1"], f["op2"],
                              f["dPdx"], a, bp, out_f)
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    ref = rk.substage_plain(
        grid, B, t["U"], t["V"], t["W"], t["U0"], t["V0"], t["W0"],
        (t["F1u"], t["F1v"], t["F1w"]) if c_prev else None, t["op1"],
        t["op2"], t["dPdx"], c_cur, c_prev, out_f)
    names = ("Un", "Vn", "Wn", "div", "Fu", "Fv", "Fw")
    for name, r in zip(names, ref):
        if r is None:
            assert not cnt[name].any()
            continue
        assert (cnt[name] == 1).all(), name
        np.testing.assert_array_equal(out[name], npa(r), err_msg=name)


def test_plane_neighbours_are_the_periodic_stencil_columns():
    Nx, Nz = 3, 5
    nbr = npa(tp.plane_neighbours(Nx, Nz))
    c = np.arange(Nx * Nz)
    x, z = c // Nz, c % Nz
    at = lambda xx, zz: (xx % Nx) * Nz + zz % Nz
    expect = [at(x - 1, z), at(x + 1, z), at(x, z - 1), at(x, z + 1),
              at(x - 1, z + 1), at(x + 1, z - 1)]
    np.testing.assert_array_equal(nbr, np.stack(expect))
    assert nbr.dtype == np.int32


# ---------------------------------------------------------------------------
# The eigen-solve kernels on spectra t (B, n, F2) -> P, with the constants
# as the host pads them.
# ---------------------------------------------------------------------------

class EigConsts:
    """What `rk3_cuda.kernel_args` uploads for one solve, in numpy."""

    def __init__(self, grid, bordered):
        c = rk.solve_consts(grid)
        p = pc.poisson_consts(grid)
        self.n = grid.Ny - 1
        self.F2 = 2 * grid.Nx * (grid.Nz // 2 + 1)
        self.bordered = bordered
        self.K = self.n - 1 if bordered else self.n
        self.Kp, self.Kq = -(-self.K // 8) * 8, -(-self.K // 4) * 4
        self.MT = npa(tp.padded_basis(c.B1 if bordered else p["Bf"]))
        self.NT = npa(tp.padded_basis(c.A1 if bordered else p["A"]))
        assert self.MT.shape == (self.Kp, self.Kq)
        self.denom = npa(c.denom1 if bordered else p["denom"])
        self.g, self.ss, self.kk = npa(c.g), npa(c.ss), npa(c.kk)
        self.dd, self.dl, self.du = npa(c.dd), npa(c.dl), npa(c.du)
        self.dlm, self.dd0h = float(c.dlm), float(c.dd0h)
        self.Pinv00 = npa(tp.padded_rows(c.Pinv00))
        self.s00 = npa(c.s00)
        self.refine = grid.refine_steps


def _column(e, q, B):
    """Tile column number q -> (env, spectrum column 1 .. F-1, F+1 ..)."""
    per_env, F = e.F2 - 2, e.F2 // 2
    r = q % per_env
    return q // per_env, r + 1 + (1 if r >= F - 1 else 0)


def emulate_zero_mode(e, B, zero_blocks, smem_floats, t, P):
    """`eig_zero_mode`: the (0,0)-mode columns by the first `zero_blocks`
    blocks of the grid, Pinv00 through a two-stage ring of row chunks."""
    n, F = e.n, e.F2 // 2
    n4 = -(-n // 4) * 4
    RZ = min(32, (smem_floats - 3 * n4) // (2 * n4))
    assert RZ >= 1
    NC = -(-n // RZ)
    done = np.zeros(2 * B, int)
    for block in range(zero_blocks):
        ring = np.full((2, RZ, n4), np.nan)
        phase = [0, 0]           # completed fills of each stage
        seq = 0

        def request(c, at):
            rows = min(RZ, n - c * RZ)
            ring[at % 2, :rows] = e.Pinv00[c * RZ:c * RZ + rows]
            phase[at % 2] += 1

        for z in range(block, 2 * B, zero_blocks):
            j = (z & 1) * F
            T0 = t[z // 2, :, j].copy()
            P0 = np.zeros(n)
            for ps in range(e.refine + 1):
                request(0, seq)
                if NC > 1:
                    request(1, seq + 1)
                v = T0.copy()
                if ps:
                    app = (e.dd + e.kk[j]) * P0
                    app = app + e.dl * np.concatenate([[0.0], P0[:-1]])
                    app = app + e.du * np.concatenate([P0[1:], [0.0]])
                    v = v - app
                    v[0] = v[0] - e.dd0h * P0[0]
                R0 = e.s00 * v
                for c in range(NC):
                    # the wait: fill number seq // 2 + 1 of this stage
                    assert phase[seq % 2] >= seq // 2 + 1
                    rows = ring[seq % 2]
                    for r in range(min(RZ, n - c * RZ)):
                        lanes = np.zeros(32)
                        for k in range(n):          # lane k % 32, in order
                            lanes[k % 32] += rows[r, k] * R0[k]
                        o = 16
                        while o:                    # the xor butterfly
                            lanes = lanes + lanes[np.arange(32) ^ o]
                            o >>= 1
                        i = c * RZ + r
                        y = e.s00[i] * lanes[0]
                        P0[i] = P0[i] + y if ps else y
                    if c + 2 < NC:
                        request(c + 2, seq + 2)
                    seq += 1
            P[z // 2, :, j] = P0
            done[z] += 1
    assert (done == 1).all()


def emulate_warp_kernel(e, plan, B, t):
    """`eig_solve_tile_kernel`: persistent blocks, a warp per pair of
    columns, three skewed tiles per warp, lanes on four (five) output rows,
    the basis through the ring of slabs in the kernel's order."""
    n, K, Kq, F2 = e.n, e.K, e.Kq, e.F2
    m, CT, RT = n - 1, tp.EIG_COLS, plan.rt
    SW = 32 * RT
    S = plan.slab
    NS, NRB = -(-e.Kp // S), -(-K // SW)
    TL = tp.eig_tile_floats(n)
    at = lambda i: CT * tp.eig_tile_row(i)
    P = np.full_like(t, np.nan)
    written = np.zeros(t.shape, int)
    emulate_zero_mode(e, B, plan.zero_blocks,
                      tp.eig_smem_bytes(n, K, plan) // 4, t, P)
    written[:, :, [0, F2 // 2]] += 1
    per_env = F2 - 2
    Q = B * per_env
    bases = (e.MT, e.NT)
    lane = np.arange(32)
    for bid in range(plan.blocks):
        q0, q1 = bid * Q // plan.blocks, (bid + 1) * Q // plan.blocks
        units = -(-(q1 - q0) // CT)
        rounds = -(-units // plan.warps)
        per_product = NRB * NS
        total = rounds * (1 + e.refine) * 2 * per_product
        ring_rows = 2 * e.Kp if plan.resident else plan.stages * S
        ring = np.full((ring_rows, Kq), np.nan)
        fills = [0] * plan.stages
        holds = [None] * plan.stages

        def request(sq, st):
            b, s = (sq // per_product) & 1, sq % NS
            rows = min(S, e.Kp - s * S)
            dst = b * e.Kp + s * S if plan.resident else st * S
            ring[dst:dst + rows] = bases[b][s * S:s * S + rows]
            fills[st] += 1
            holds[st] = (b, s)

        first = 2 * NS if plan.resident else min(plan.stages, total)
        for s in range(first):
            request((s // NS) * per_product + s % NS if plan.resident else s, s)
        tiles = np.full((plan.warps, 3, TL), np.nan)
        seq = 0      # the same in every warp: they are emulated in step
        for rd in range(rounds):
            live_w = [w for w in range(plan.warps)
                      if not plan.resident or rd * plan.warps + w < units]
            info = {}
            for w in live_w:
                unit = rd * plan.warps + w
                jc, env, live = [], [], []
                for c in range(CT):
                    q = q0 + unit * CT + c
                    ok = unit < units and q < q1
                    en, j = _column(e, q if ok else q0, B)
                    jc.append(j)
                    env.append(en)
                    live.append(ok)
                info[w] = (jc, env, live)
            for ps in range(e.refine + 1):
                for w in live_w:
                    jc, env, live = info[w]
                    RY, U, Pt = tiles[w]
                    for i in range(n):
                        for c in range(CT):
                            tv = t[env[c], i, jc[c]] if live[c] else 0.0
                            rv = tv
                            if ps:
                                pm = Pt[at(max(i - 1, 0)) + c]
                                pp = Pt[at(min(i + 1, n - 1)) + c]
                                app = (e.dd[i] + e.kk[jc[c]]) * Pt[at(i) + c]
                                app = app + e.dl[i] * (pm if i > 0 else 0.0)
                                app = app + e.du[i] * (pp if i < n - 1
                                                       else 0.0)
                                rv = tv - app
                            RY[at(i) + c] = rv
                            U[at(i) + c] = (e.denom[i, jc[c]] if i < K
                                            else 1.0)
                for b in range(2):
                    for rb in range(NRB):
                        row4 = rb * SW + 4 * lane
                        row5 = rb * SW + 128 + lane
                        acc = {w: np.zeros((32, RT, CT)) for w in live_w}
                        if plan.resident:
                            slabs = [(b * NS + sl, b * e.Kp + sl * S, sl * S)
                                     for sl in range(NS)]
                        else:
                            slabs = [((seq + sl) % plan.stages,
                                      ((seq + sl) % plan.stages) * S, sl * S)
                                     for sl in range(NS)]
                        for sl, (st, base, k0) in enumerate(slabs):
                            if plan.resident:
                                assert fills[st] == 1
                            else:
                                # the wait's parity: fill number
                                # (seq + sl) // stages + 1 has landed
                                assert fills[st] == (seq + sl) // plan.stages + 1
                            assert holds[st] == (b, sl)
                            for w in live_w:
                                x = tiles[w][1 if b else 0]
                                for k in range(k0, min(K, k0 + S)):
                                    mrow = ring[base + k - k0]
                                    xv = x[at(k):at(k) + CT]
                                    for j in range(4):
                                        ok = row4 < Kq
                                        mv = np.where(
                                            ok, mrow[np.minimum(row4 + j,
                                                                Kq - 1)], 0.0)
                                        acc[w][:, j] += mv[:, None] * xv
                                    if RT == 5:
                                        ok = row5 < K
                                        mv = np.where(
                                            ok, mrow[np.minimum(row5, Kq - 1)],
                                            0.0)
                                        acc[w][:, 4] += mv[:, None] * xv
                            if not plan.resident and \
                                    seq + sl + plan.stages < total:
                                request(seq + sl + plan.stages, st)
                        seq += NS
                        for w in live_w:
                            RY, U, _ = tiles[w]
                            y, D = (RY, None) if b else (U, U)
                            for ln in range(32):
                                for j in range(RT):
                                    i = row4[ln] + j if j < 4 else row5[ln]
                                    if i >= K:
                                        continue
                                    v = acc[w][ln, j].copy()
                                    if D is not None:
                                        v = v / D[at(i):at(i) + CT]
                                    y[at(i):at(i) + CT] = v
                for w in live_w:
                    jc, env, live = info[w]
                    RY, U, Pt = tiles[w]
                    last = np.zeros(CT)
                    if e.bordered:
                        for c in range(CT):
                            last[c] = (RY[at(m) + c] - e.dlm
                                       * RY[at(m - 1) + c]) / e.ss[jc[c]]
                    for i in range(n):
                        for c in range(CT):
                            v = RY[at(i) + c]
                            if e.bordered:
                                v = (v - e.g[i, jc[c]] * last[c] if i < m
                                     else last[c])
                            Pt[at(i) + c] = Pt[at(i) + c] + v if ps else v
            for w in live_w:
                jc, env, live = info[w]
                for c in range(CT):
                    if live[c]:
                        for i in range(n):
                            P[env[c], i, jc[c]] = tiles[w][2][at(i) + c]
                        written[env[c], :, jc[c]] += 1
        assert plan.resident or seq == total
    assert (written == 1).all()
    return P


def emulate_rows_kernel(e, plan, B, t):
    """`eig_solve_rows_kernel`: a block per tile of tc columns behind the
    (0,0)-mode blocks, a thread per row, the contraction from a k that
    depends on the block, wrapping."""
    n, K, F2, TC = e.n, e.K, e.F2, plan.tc
    m = n - 1
    P = np.full_like(t, np.nan)
    written = np.zeros(t.shape, int)
    emulate_zero_mode(e, B, plan.zero_blocks, tp.eig_rows_smem_bytes(n, TC) // 4,
                      t, P)
    written[:, :, [0, F2 // 2]] += 1
    Q = B * (F2 - 2)
    assert plan.blocks * TC >= Q
    for tile_id in range(plan.blocks):
        block = plan.zero_blocks + tile_id
        qs = [tile_id * TC + c for c in range(TC)]
        live = [q < Q for q in qs]
        col = [_column(e, q if ok else 0, B) for q, ok in zip(qs, live)]
        env, jc = [c[0] for c in col], [c[1] for c in col]
        T = np.array([[t[env[c], i, jc[c]] if live[c] else 0.0
                       for c in range(TC)] for i in range(n)])
        Pt = np.zeros((n, TC))
        k0 = (block * 37) % K
        order = list(range(k0, K)) + list(range(k0))

        def product(M, x, D):
            y = np.zeros((K, TC))
            for k in order:
                y += M[k, :K, None] * x[k]
            return y / D if D is not None else y

        for ps in range(e.refine + 1):
            r = T
            if ps:
                app = (e.dd[:, None] + e.kk[jc][None]) * Pt
                app = app + e.dl[:, None] * np.vstack([np.zeros(TC), Pt[:-1]])
                app = app + e.du[:, None] * np.vstack([Pt[1:], np.zeros(TC)])
                r = T - app
            U = product(e.MT, r, e.denom[:K][:, jc])
            Y = product(e.NT, U, None)
            v = Y
            if e.bordered:
                last = (r[m] - e.dlm * Y[m - 1]) / e.ss[jc]
                v = np.vstack([Y - e.g[:, jc] * last, last])
            Pt = Pt + v if ps else v
        for c in range(TC):
            if live[c]:
                P[env[c], :, jc[c]] = Pt[:, c]
                written[env[c], :, jc[c]] += 1
    assert (written == 1).all()
    return P


def _solve_reference(grid, bordered, Y):
    """The plain versions on Y (B, Nx, n, Nz) -> p, same layout."""
    if bordered:
        return rk._poisson_bordered_plain(grid, rk.solve_consts(grid), Y)
    return torch.stack([pc.poisson_solve_plain(grid, y) for y in Y])


def _check_solve(grid, bordered, B, plan, seed):
    e = EigConsts(grid, bordered)
    rng = np.random.default_rng(seed)
    Y = torch.as_tensor(rng.standard_normal((B, grid.Nx, e.n, grid.Nz)))
    c = rk.solve_consts(grid)
    t = npa(rk._spec(Y) @ c.T2)
    emu = emulate_rows_kernel if plan.tc else emulate_warp_kernel
    P = torch.as_tensor(emu(e, plan, B, t))
    p = (P @ c.Ti2).reshape(B, e.n, grid.Nx, grid.Nz).permute(0, 2, 1, 3)
    ref = _solve_reference(grid, bordered, Y)
    err = float((p - ref).norm() / ref.norm())
    # float64 sums of K terms in another order than the plain version's
    # matrix products: under 1e-12 up to K = 129; on the 259-point mesh
    # (K = 257, its denominators spread over ten decades) the two sit 2e-12
    # apart after a refinement pass, whatever the plan
    assert err < (1e-12 if e.K <= 129 else 4e-12), err


def _grid_for(K, bordered, refine):
    n = K + 1 if bordered else K
    return grid64(2, n + 1, 4, refine)


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("bordered", [True, False])
@pytest.mark.parametrize("K", [8, 32, 128, 129, 257])
def test_eig_plan_route_against_plain(K, bordered, refine):
    """The kernel the host rule picks for a three-env solve on four SMs
    (tile columns straddle envs and end ragged), emulated."""
    grid = _grid_for(K, bordered, refine)
    n, F2 = grid.Ny - 1, 2 * grid.Nx * (grid.Nz // 2 + 1)
    plan = tp.eig_plan(n, K, 3, F2, sms=4)
    _check_solve(grid, bordered, 3, plan, seed=K)


WARP_PLANS = [
    # slab, stages, resident, blocks, zero_blocks, warps
    (32, None, 1, 3, 2, 2),     # resident, several rounds, ragged last unit
    (32, None, 1, 1, 1, 8),     # one block, one round
    (8, 2, 0, 2, 1, 3),         # streamed, two stages
    (16, 3, 0, 2, 6, 2),        # streamed, three stages
    (32, 1, 0, 1, 2, 4),        # streamed through one stage
]


@pytest.mark.parametrize("shape", WARP_PLANS)
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("bordered", [True, False])
@pytest.mark.parametrize("K", [8, 32, 129, 257])
def test_warp_owned_kernel_against_plain(K, bordered, refine, shape):
    """The warp-owned kernel under plans the rule reaches only on the card's
    sizes: resident and streamed rings, several rounds, warps without a
    unit, both row counts per lane."""
    slab, stages, resident, blocks, zero_blocks, warps = shape
    grid = _grid_for(K, bordered, refine)
    rt = 5 if -(-K // 160) * 5 < -(-K // 128) * 4 else 4
    if resident:
        stages = 2 * -(-(-(-K // 8) * 8) // slab)
    plan = tp.EigPlan(0, rt, slab, stages, resident, blocks, zero_blocks,
                      warps)
    for B in (1, 3):
        _check_solve(grid, bordered, B, plan, seed=K + B)


@pytest.mark.parametrize("tc", [8, 16])
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("bordered", [True, False])
@pytest.mark.parametrize("K", [8, 32, 129])
def test_row_owned_kernel_against_plain(K, bordered, refine, tc):
    grid = _grid_for(K, bordered, refine)
    F2 = 2 * grid.Nx * (grid.Nz // 2 + 1)
    for B in (1, 3):
        plan = tp.EigPlan(tc, 0, 0, 0, 0, -(-B * (F2 - 2) // tc), 2 * B, 0)
        _check_solve(grid, bordered, B, plan, seed=K + B + tc)


# ---------------------------------------------------------------------------
# The host rules.
# ---------------------------------------------------------------------------

def test_padded_constants():
    a = torch.arange(49.0).reshape(7, 7)
    b = tp.padded_basis(a)
    assert b.shape == (8, 8) and b.is_contiguous()
    assert torch.equal(b[:7, :7], a.T) and not b[7].any() and not b[:, 7].any()
    r = tp.padded_rows(a)
    assert r.shape == (7, 8) and torch.equal(r[:, :7], a) and not r[:, 7].any()
    assert tp.padded_basis(torch.zeros(128, 128)).shape == (128, 128)
    assert tp.padded_basis(torch.zeros(129, 129)).shape == (136, 132)


def test_div_rn_with_the_hosts_reciprocals_is_the_rounded_quotient():
    """`div_rn` of csrc/common.cuh (a product, then two residual corrections
    in FMA) on the reciprocals the host uploads, emulated in float32 with
    the FMAs through float64: the IEEE quotient, bit for bit, on a graded
    mesh's spacings and on random operands."""
    def fma(a, b, c):
        return (a.astype(np.float64) * b.astype(np.float64)
                + c.astype(np.float64)).astype(np.float32)

    rng = np.random.default_rng(0)
    grid = grid64(2, 130, 4)
    dyf = npa(rk.solve_consts(grid).dyf).astype(np.float32)
    d = np.concatenate([dyf, rng.uniform(1e-4, 10.0, 5000)
                        .astype(np.float32)])
    r = tp.reciprocals(torch.as_tensor(d))
    assert r.dtype == np.float32
    for _ in range(20):
        x = (rng.standard_normal(d.shape)
             * 10.0 ** rng.integers(-6, 3)).astype(np.float32)
        q = x * r
        q = fma(fma(-d, q, x), r, q)
        q = fma(fma(-d, q, x), r, q)
        np.testing.assert_array_equal(q, x / d)
    assert float(tp.reciprocals(0.5)) == 2.0


def test_eig_tile_rows_spread_a_lanes_stores_over_the_banks():
    """Rows 4 l + j of eight neighbouring lanes land in eight different
    16-byte... 8-byte slots modulo the 32 banks; the layout is injective
    and a tile holds the rows up to the next multiple of 8."""
    rows = [tp.eig_tile_row(i) for i in range(300)]
    assert rows == sorted(set(rows))
    for j in range(4):
        for l0 in range(0, 32, 8):
            slots = {tp.eig_tile_row(4 * l + j) % 8 for l in range(l0, l0 + 8)}
            assert len(slots) == 8
    assert tp.eig_tile_floats(129) == 2 * (tp.eig_tile_row(135) + 1)


def test_eig_plan_at_the_main_shapes():
    F2 = 2 * 32 * 17
    p = tp.eig_plan(129, 128, 1, F2)
    assert (p.tc, p.rt, p.resident, p.blocks, p.zero_blocks, p.warps) == \
        (0, 4, 1, 130, 2, 5)
    assert p.stages == 2 * (128 // p.slab)
    assert tp.eig_smem_bytes(129, 128, p) <= tp.EIG_SMEM_BUDGET
    full = tp.eig_plan(129, 129, 1, F2)
    assert (full.tc, full.rt, full.resident) == (0, 5, 1)
    for B, lean in ((2, 0), (4, 0), (7, 0), (8, 1), (64, 1)):
        p = tp.eig_plan(129, 128, B, F2)
        assert p.tc == 8 and p.blocks * 8 >= B * (F2 - 2) > (p.blocks - 1) * 8
        assert p.zero_blocks == min(2 * B, tp.H100_SMS)
        assert p.lean == lean
    assert full.lean == 0


def test_eig_plan_resident_or_streamed():
    # a basis that fits beside the tiles is resident; K = 256 is not
    assert tp.eig_plan(151, 150, 1, 80).resident == 1
    p = tp.eig_plan(257, 256, 1, 80)
    assert (p.tc, p.resident) == (0, 0) and p.stages >= 2
    assert tp.eig_smem_bytes(257, 256, p) <= tp.EIG_SMEM_BUDGET
    # every plan the rule makes fits its kernel's shared memory
    for n in (2, 9, 129, 300, 700, 1452, 1453, 2000, 3000):
        for K in (n, n - 1):
            for B in (1, 8):
                p = tp.eig_plan(n, K, B, 1088)
                if p.tc:
                    assert tp.eig_rows_smem_bytes(n, p.tc) <= tp.MAX_DYNAMIC_SMEM
                else:
                    assert tp.eig_smem_bytes(n, K, p) <= tp.EIG_SMEM_BUDGET
                    assert 1 <= p.warps <= tp.EIG_MAX_WARPS
                    assert 1 <= p.stages <= tp.EIG_MAX_STAGES
                    assert p.slab in (8, 16, 32)


def test_eig_plan_tall_grids_and_the_limit():
    """Beyond the row-owned kernel's tiles (Ny > 1453) the warp-owned kernel
    streams the basis; the limit did not shrink, and above the new one the
    rule raises before any launch."""
    assert tp.eig_plan(1452, 1451, 8, 1088).tc == 8
    p = tp.eig_plan(1453, 1452, 8, 1088)
    assert (p.tc, p.resident) == (0, 0)
    ok = tp.eig_plan(3256, 3255, 1, 80)
    assert ok.tc == 0 and ok.warps == 1
    with pytest.raises(ValueError, match="shared memory"):
        tp.eig_plan(3400, 3400, 1, 80)
    with pytest.raises(ValueError):
        tp.eig_plan(1, 1, 1, 80)


def test_substage_rows_rule():
    C = 32 * 32
    assert tp.substage_rows(1, 130, C) == 1          # 129 blocks, 132 SMs
    assert tp.substage_rows(8, 130, C) == 2          # 520 blocks, two per SM
    assert tp.substage_rows(4, 130, C) == 2          # 260 blocks
    assert tp.substage_rows(2, 130, C) == 1          # 130 blocks
    assert tp.substage_rows(1, 130, 6 * 5) == 0      # no multiple of 16 bytes
    assert tp.substage_rows(1, 2, C) == 0
    assert tp.substage_smem_bytes(1, 4148) <= tp.MAX_DYNAMIC_SMEM
    assert tp.substage_rows(64, 130, 4148) == 1      # two rows do not fit
    assert tp.substage_rows(1, 130, 4152) == 0       # one row does not fit
    for rows in (1, 2):
        assert tp.substage_smem_bytes(rows, C) == 4 * (6 * rows + 8) * C


def test_kernel_args_needs_a_card():
    grid = grid64(2, 9, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rk.kernel_args(grid, 1)


# ---------------------------------------------------------------------------
# The ctypes mirrors against the structs' text.
# ---------------------------------------------------------------------------

def _struct_fields(name, source="common.cuh"):
    """Field names of `struct name` in csrc/`source`, in order."""
    src = (cuda_build.CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        decl = re.sub(r"^(const\s+)?(long\s+long|\w+)\s*\*?", "", decl,
                      count=1)
        names += [re.sub(r"[\s*]|\[\w+\]", "", v) for v in decl.split(",")]
    return names


@pytest.mark.parametrize("name", ["Ops", "Dims", "EigPlan", "Work",
                                  "CornerDims", "SpectralDims",
                                  "CornerDwDims", "AdamLeaf", "AdamTable"])
def test_ctypes_mirror_names_the_structs_fields_in_order(name):
    source = "corner_contract.cu" if "Corner" in name or "Spectral" in name \
        else "adam.cu" if "Adam" in name else "common.cuh"
    mirror = [f[0] for f in getattr(cuda_build, name)._fields_]
    assert mirror == _struct_fields(name, source)


def test_ops_carries_no_dead_pointer():
    """Every pointer of `Ops` is read somewhere in the sources."""
    src = "".join(f.read_text() for f in cuda_build.CSRC.glob("*.cu*"))
    for name, _ in cuda_build.Ops._fields_:
        assert re.search(r"\bo(\.|->)%s\b" % name, src), name


def test_plan_dataclass_matches_its_ctypes_mirror():
    fields = [f[0] for f in cuda_build.EigPlan._fields_]
    assert fields == list(tp.EigPlan.__dataclass_fields__)
    assert all(f[1] is ctypes.c_int for f in cuda_build.EigPlan._fields_)


# ---------------------------------------------------------------------------
# The Poisson kernel's error on tall graded grids, in float32: what sets it.
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf: the exact product and sum, rounded once to float32 (through
    float64, where a product of two floats is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def emulate_eig_solve_f32(grid, R, bordered, exact_sums=False):
    """The eigen-solve kernels in float32 on a float32 grid and a float32
    spectrum R (n, 2F): both products summed over k in order by fmaf in
    one thread (the warp-owned kernel's order, which a streamed basis
    keeps), for the bordered solve the Schur finish of the last row, the
    (0,0) columns by lanes and butterfly (`eig_zero_mode`), the refinement
    passes.  exact_sums: every product in float64, rounded once (the
    float32 constants and spectrum left as the only error)."""
    n, F = grid.Ny - 1, R.shape[1] // 2
    m = n - 1
    c = rk.solve_consts(grid)
    if bordered:
        den, Bf, A = npa(c.denom1), npa(c.B1), npa(c.A1)
        g, ss, dlm = npa(c.g), npa(c.ss), np.float32(float(c.dlm))
    else:
        den = npa(pc.poisson_consts(grid)["denom"])
        Bf, A = npa(grid.eig_B), npa(grid.eig_A)
    s00, Pi, kk = npa(grid.s00), npa(grid.Pinv00_eq), npa(c.kk)
    dd, dl, du = npa(c.dd), npa(c.dl), npa(c.du)
    zc = [0, F]

    def prod(M, x):
        if exact_sums:
            return (M.astype(np.float64) @ x).astype(np.float32)
        y = np.zeros((M.shape[0], x.shape[1]), np.float32)
        for k in range(M.shape[1]):
            y = _fma32(M[:, k:k + 1], x[k:k + 1], y)
        return y

    def solve(r):
        if bordered:
            y = prod(A, prod(Bf, r[:m]) / den)
            last = (r[m] - dlm * y[m - 1]) / ss
            P = np.vstack([y - g * last, last])
        else:
            P = prod(A, prod(Bf, r) / den)
        for j in zc:
            v = s00 * r[:, j]
            if exact_sums:
                y = (Pi.astype(np.float64) @ v).astype(np.float32)
            else:
                lanes = np.zeros((n, 32), np.float32)
                for k in range(n):
                    lanes[:, k % 32] = _fma32(Pi[:, k], v[k], lanes[:, k % 32])
                o = 16
                while o:
                    lanes = lanes + lanes[:, np.arange(32) ^ o]
                    o >>= 1
                y = lanes[:, 0]
            P[:, j] = s00 * y
        return P

    P = solve(R)
    zero = np.zeros((1, 2 * F), np.float32)
    for _ in range(grid.refine_steps):
        app = (dd[:, None] + kk[None]) * P
        app = app + dl[:, None] * np.vstack([zero, P[:-1]])
        app = app + du[:, None] * np.vstack([P[1:], zero])
        r = R - app
        r[0, zc] = r[0, zc] - np.float32(float(c.dd0h)) * P[0, zc]
        P = P + solve(r)
    return P


def emulate_poisson_f32(grid, rhs, exact_sums=False):
    """The Poisson kernel in float32 on a float32 grid: the spectrum of
    rhs rounded to float32, `emulate_eig_solve_f32`, then the inverse
    transform in float64."""
    Nx, Nz, n = grid.Nx, grid.Nz, grid.Ny - 1
    Nzr = Nz // 2 + 1
    F = Nx * Nzr
    Rc = torch.fft.fft(torch.fft.rfft(torch.as_tensor(rhs).double(), dim=-1),
                       dim=-3)
    R = torch.stack([Rc.real, Rc.imag]).numpy().astype(np.float32)
    R = R.transpose(2, 0, 1, 3).reshape(n, 2 * F)
    P = emulate_eig_solve_f32(grid, R, False, exact_sums)
    Pd = P.astype(np.float64).reshape(n, 2, Nx, Nzr).transpose(1, 2, 0, 3)
    Pc = torch.complex(torch.as_tensor(Pd[0]), torch.as_tensor(Pd[1]))
    return torch.fft.irfft(torch.fft.ifft(Pc, dim=-3), n=Nz, dim=-1)


@pytest.mark.parametrize("shape", [(8, 258, 8), (2, 1455, 2)])
def test_tall_grid_poisson_error_is_float32_rounding_in_the_solve(shape):
    """On tall graded grids both float32 Poisson solves sit ~1e-4 .. 1e-3
    from a float64 grid's solve.  What sets that distance is float32
    rounding inside the solve (the spectrum, u = B r / denom, y = A u, P),
    not the float32 constants and not the order of the sums: a float64
    solve on the float32 grid's own constants is 3-6x
    closer, and the kernel's order with every product exact and rounded
    once is as far as the kernel.  The kernel's float32 sums and the plain
    version's each scatter around that distance (0.7x .. 1.75x of it over
    twelve right-hand sides), so on one right-hand side either can lead by
    1.7x; over several the kernel is no further than the plain version.
    The limit on the card follows: over eight right-hand sides the
    geometric mean of kernel / plain error at most 1.25, any one at most
    2 (chip_smoke.py)."""
    g32 = cf.make_channel_grid(*shape, device="cpu")
    g64 = grid64(*shape, refine=0)
    f64c = dataclasses.replace(g32, cache={}, **{
        k: getattr(g32, k).double() for k in cf._GRID_TENSORS})
    ratios = []
    for seed in range(6):
        rng = np.random.default_rng(seed)
        rhs = rng.standard_normal((shape[0], shape[1] - 1, shape[2]))
        rhs = torch.as_tensor((rhs - rhs.mean()).astype(np.float32))
        exact = pc.poisson_solve_plain(g64, rhs.double())

        def err(p):
            return float((p.double() - exact).norm() / exact.norm())
        kernel = err(emulate_poisson_f32(g32, rhs.numpy()))
        rounded = err(emulate_poisson_f32(g32, rhs.numpy(), exact_sums=True))
        plain = err(pc.poisson_solve_plain(g32, rhs))
        floor = err(pc.poisson_solve_plain(f64c, rhs.double()))
        assert rounded > 1e-4 and rounded > 2.5 * floor
        assert 0.5 < kernel / rounded < 2.0 and 0.5 < plain / rounded < 2.0
        ratios.append(kernel / plain)
    assert max(ratios) < 2.0
    assert float(np.exp(np.mean(np.log(ratios)))) <= 1.25, ratios


def test_tall_grid_kernel_b_error_is_float32_rounding_in_the_solve():
    """Kernel B on 2x1455x2 with chip_smoke.py's inputs (a divergence of
    0.01 N(0, 1), U, V, W N(0, 1)): the plain float32 step itself sits up
    to 3e-5 from a float64 grid's step in one field, so the 2e-5 against
    plain that the other grids hold falls under this grid's float32 floor.
    What sets the distance is float32 rounding inside the bordered solve
    (the spectrum, u = B1 r / denom1, y = A1 u): a float64 solve on the
    float32 grid's own constants is several times closer, and the kernel's
    order with every product exact and rounded once is as far as the
    kernel.  Over six draws the kernel's order is no further from float64
    than the plain version (geometric mean of kernel / plain at most 1.25,
    any one under 2): the limit chip_smoke.py holds kernel B to on the tall
    grids, over eight draws."""
    shape = (2, 1455, 2)
    g32 = cf.make_channel_grid(*shape, device="cpu")
    g64 = grid64(*shape, refine=0)
    f64c = dataclasses.replace(g32, cache={}, **{
        k: getattr(g32, k).double() for k in cf._GRID_TENSORS})
    c32 = rk.solve_consts(g32)
    gy, cols = shape[1], shape[0] * shape[2]
    ratios, plain_fields = [], []
    for seed in range(6):
        rng = np.random.default_rng(seed)

        def rnd(rows):
            return torch.as_tensor(rng.standard_normal((rows, cols))
                                   .astype(np.float32))
        args = (0.01 * rnd(gy - 1), rnd(gy + 1), rnd(gy), rnd(gy + 1),
                rnd(1), rnd(1))
        a64 = [a.double() for a in args]
        exact = rk.solve_correct_plain(g64, 1, *a64)
        t = npa((rk._spec(rk._unpack(a64[0], g32, 1)) @ c32.T2.double())[0]
                ).astype(np.float32)

        def corrected(P):
            """The emulated solve's p, the correction and the BCs in
            float64 (the solve is what is being weighed)."""
            p = torch.as_tensor(P.astype(np.float64)) @ c32.Ti2.double()
            p = p.reshape(1, gy - 1, shape[0], shape[2]).permute(0, 2, 1, 3)
            U, V, W = (rk._unpack(a, f64c, 1) for a in a64[1:4])
            U, V, W = cf.apply_boundary_condition(
                *cf.pressure_correction(f64c, U, V, W, p),
                *(a.reshape(1, shape[0], shape[2]) for a in a64[4:]))
            return rk._pack(U), rk._pack(V), rk._pack(W)

        def err(fields):
            a = torch.cat([f.double().flatten() for f in fields])
            b = torch.cat([f.flatten() for f in exact])
            return float((a - b).norm() / b.norm())
        plain = rk.solve_correct_plain(g32, 1, *args)
        kernel = err(corrected(emulate_eig_solve_f32(g32, t, True)))
        rounded = err(corrected(emulate_eig_solve_f32(g32, t, True,
                                                      exact_sums=True)))
        floor = err(rk.solve_correct_plain(f64c, 1, *a64))
        assert rounded > 2.5 * floor, (rounded, floor)
        assert 0.5 < kernel / rounded < 2.0 and 0.5 < err(plain) / rounded < 2
        ratios.append(kernel / err(plain))
        plain_fields.append(max(float((p.double() - e).norm() / e.norm())
                                for p, e in zip(plain, exact)))
    assert max(plain_fields) > 2e-5, plain_fields
    assert max(ratios) < 2.0
    assert float(np.exp(np.mean(np.log(ratios)))) <= 1.25, ratios


def test_row_owned_residency_follows_the_registers(monkeypatch):
    """The 40-register build where the launch has more blocks than an SM
    holds of the 48-register one: eight and ten blocks of five warps from
    the registers `EIG_ROWS_REGISTERS` records (chip_smoke.py holds them to
    the build log).  Should ptxas give the kernel more, the rule moves with
    them: at 64 registers (six blocks an SM) seven envs take the 40-register
    build."""
    F2 = 2 * 32 * 17
    assert (tp.eig_rows_resident(0), tp.eig_rows_resident(1)) == (8, 10)
    assert tp.eig_plan(129, 128, 7, F2).lean == 0
    monkeypatch.setattr(tp, "EIG_ROWS_REGISTERS", (64, 40))
    assert tp.eig_rows_resident(0) == 6
    assert tp.eig_plan(129, 128, 7, F2).lean == 1
