"""Device time of the eigen-solve, of kernel A's stencil pass and of the
wall pair under each route the host rules choose between, at 32x130x32:
the measurements behind `envs/tile_plan.py:eig_plan`, `substage_rows` and
`boundary_rows`.

    python -m pde_policylearning_torch.tools.kernel_routes [--out DIR]
                                                           [--default-only]

For B = 1, 2, 4 and 8 envs (developed states: eight kernel-D steps from the
snapshot) it runs stage 1 of kernel A, kernel B and the two phases of the
wall pair under `torch.profiler` and prints the device us per call of the
eigen-solve kernels, of kernel A's launches and of each wall phase's
launches: first with the plans the rules make, then with the bordered
eigen-solve's plan overwritten in the cached kernel arguments (the
warp-owned kernel, the row-owned kernel in its 48- and 40-register builds),
with kernel A's rows per block set to 0 (the point-by-point pass and its
divergence launch), 1, 2, 4 and 8, and with the wall pass's set to 0 (the
three launches), 1, 2 and 4.  Every forced route is also held against the
plain version (relative L2 of V after kernel B, maximum absolute error of
kernel A and of the wall pass's spectrum).  `--default-only` skips the
forced routes: that part reads nothing of `tile_plan` and so runs in a
checkout of an earlier commit too, for a comparison inside one call on one
card.  The registers per thread that ptxas gave each eigen-solve and
plane-pass kernel are printed too (a block's registers bound how many of
its blocks an SM holds).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from ..envs import channel_flow as cf
from ..envs import rk3_cuda as rk
from ..envs.control_env import default_snapshot_path
from ..utils import set_solver_precision
from . import card_name

EIG = ("eig_solve_tile", "eig_solve_rows")
KERNEL_A = ("substage_planes", "substage_kernel", "divergence_kernel")
WALL_FWD = ("boundary_planes", "rhs_fields", "divergence_kernel",
            "xz_fft_forward", "gemm", "split_sum")
WALL_SOLVE = ("wall_solve", "xz_fft_inverse", "gemm", "split_sum",
              "solve00", "boundary_finish")
PLAN_FIELDS = ("tc", "rt", "slab", "stages", "resident", "blocks",
               "zero_blocks", "warps", "lean")


def forced_plans(n: int, F2: int, B: int, sms: int):
    """{route name: plan} for the bordered eigen-solve of B envs: the
    warp-owned kernel (the rule's plan with the row-owned kernel's tiles
    declared not to fit) and the row-owned kernel in both of its builds
    (`EigPlan.lean`)."""
    from ..envs import tile_plan
    fits = tile_plan.eig_rows_smem_bytes
    tile_plan.eig_rows_smem_bytes = lambda n, tc: tile_plan.MAX_DYNAMIC_SMEM + 1
    try:
        warp = tile_plan.eig_plan(n, n - 1, B, F2, sms)
    finally:
        tile_plan.eig_rows_smem_bytes = fits
    rows = {f"row-owned, {regs} registers": tile_plan.EigPlan(
        8, 0, 0, 0, 0, -(-B * (F2 - 2) // 8), min(2 * B, sms), 0, lean)
        for lean, regs in enumerate(tile_plan.EIG_ROWS_REGISTERS)}
    return {"warp-owned": warp, **rows}


def device_us(fn, names, reps: int = 10):
    """Device us per call of the kernels whose name holds one of `names`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(n in e.key for n in names)) / reps


def kernel_registers(log: str, names=EIG + ("substage_planes",
                                            "boundary_planes",
                                            "wall_solve")) -> dict:
    """{mangled kernel name: registers per thread} from ptxas' -v output
    (`cuda_build.build_log`), for the kernels whose name holds one of
    `names`."""
    regs, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w.$]+)'?", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn and any(n in fn for n in names):
            regs[fn] = int(m.group(1))
    return regs


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def kernel_routes(default_only: bool = False, batches=(1, 2, 4, 8)):
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_routes needs a CUDA card")
    dev = torch.device("cuda")
    set_solver_precision()
    grid = cf.make_channel_grid(device=dev)
    snap = np.load(default_snapshot_path())
    st = rk.state_to_kstate(cf.init_state(
        grid, U=snap["U"], V=snap["V"], W=snap["W"],
        dPdx=float(snap["dPdx"])))

    def step_args(states):
        def cat(name):
            return torch.cat([getattr(s, name) for s in states],
                             1).contiguous()
        ops = [cf.gt_control(s, 25) for s in states]
        return (grid, len(states), cat("U"), cat("V"), cat("W"),
                torch.stack([s.dPdx for s in states]),
                torch.stack([s.meanU0 for s in states]),
                torch.cat([o[0] for o in ops])[None].contiguous(),
                torch.cat([o[1] for o in ops])[None].contiguous())

    states = []
    for _ in range(max(batches)):
        U, V, W, dPdx, _ = rk.env_step_full_kb_kernel(*step_args([st]))
        st = st.replace(U=U, V=V, W=W, dPdx=dPdx.reshape(()))
        states.append(st)
    n, F2 = grid.Ny - 1, 2 * grid.Nx * (grid.Nz // 2 + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    from ..native import cuda_build
    res = {"card": card_name(),
           "registers": kernel_registers(getattr(cuda_build, "build_log",
                                                 ""))}
    print("registers", json.dumps(res["registers"]), flush=True)
    for B in batches:
        _, _, U0, V0, W0, dP, _, op1, op2 = step_args(states[-B:])
        a_args = (grid, B, U0, V0, W0, U0, V0, W0, None, op1, op2, dP,
                  *rk._RK3_STAGES[0], True)
        ref_a = rk.substage_plain(*a_args)
        b_args = (grid, B, ref_a[3], *ref_a[:3], op1, op2)
        ref_b = rk.solve_correct_plain(*b_args)

        def run_a():
            return rk.substage_kernel(*a_args)

        def run_b():
            return rk.solve_correct_kernel(*b_args)

        t_w = rk.boundary_fwd_plain(grid, U0, V0, W0, dP)

        def run_wf():
            return rk.boundary_fwd_kernel(grid, U0, V0, W0, dP)

        def run_ws():
            return rk.boundary_solve_kernel(grid, t_w)

        row = {"eig_us": device_us(run_b, EIG),
               "kernel_a_us": device_us(run_a, KERNEL_A),
               "wall_fwd_us": device_us(run_wf, WALL_FWD),
               "wall_solve_us": device_us(run_ws, WALL_SOLVE)}
        if not default_only:
            args = rk.kernel_args(grid, B)
            plan = args.dims.eig[1]
            keep = [getattr(plan, k) for k in PLAN_FIELDS]
            for name, forced in forced_plans(n, F2, B, sms).items():
                for k in PLAN_FIELDS:
                    setattr(plan, k, getattr(forced, k))
                row[f"eig_us, {name}"] = device_us(run_b, EIG)
                row[f"V error, {name}"] = rel(run_b()[1], ref_b[1])
            for k, v in zip(PLAN_FIELDS, keep):
                setattr(plan, k, v)
            rows_kept = args.dims.sub_rows
            for rows in (0, 1, 2, 4, 8):
                args.dims.sub_rows = rows
                row[f"kernel_a_us, {rows} rows per block"] = device_us(
                    run_a, KERNEL_A)
                row[f"kernel A error, {rows} rows per block"] = max(
                    float((o - r).abs().max())
                    for o, r in zip(run_a(), ref_a))
            args.dims.sub_rows = rows_kept
            rows_kept, t_k = args.dims.bnd_rows, run_wf()
            for rows in (0, 1, 2, 4):
                args.dims.bnd_rows = rows
                row[f"wall_fwd_us, {rows} rows per block"] = device_us(
                    run_wf, WALL_FWD)
                row[f"wall pass error, {rows} rows per block"] = float(
                    (run_wf() - t_k).abs().max())
            args.dims.bnd_rows = rows_kept
        res[f"B{B}"] = row
        print(f"B{B}", json.dumps(row), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--default-only", action="store_true")
    args = ap.parse_args(argv)
    res = kernel_routes(args.default_only)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_routes.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
