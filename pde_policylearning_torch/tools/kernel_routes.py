"""Device time of the eigen-solve and of kernel A's stencil pass under each
route the host rules choose between, at 32x130x32: the measurements behind
`envs/tile_plan.py:eig_plan` and `substage_rows`.

    python -m pde_policylearning_torch.tools.kernel_routes [--out DIR]
                                                           [--default-only]

For B = 1, 2, 4 and 8 envs (developed states: eight kernel-D steps from the
snapshot) it runs stage 1 of kernel A and kernel B under `torch.profiler`
and prints the device us per launch of the eigen-solve kernels and of kernel
A's launches: first with the plans the rules make, then with the bordered
eigen-solve's plan overwritten in the cached kernel arguments (the
warp-owned kernel, the row-owned kernel with tiles of 8 and of 16 columns)
and with kernel A's rows per block set to 0 (the point-by-point pass and
its divergence launch), 1, 2, 4 and 8.  Every forced route is also held
against the plain version (relative L2 of V after kernel B, maximum
absolute error of kernel A).  `--default-only` skips the forced routes: that
part reads nothing of `tile_plan` and so runs in a checkout of an earlier
commit too, for a comparison inside one call on one card.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..envs import channel_flow as cf
from ..envs import rk3_cuda as rk
from ..envs.control_env import default_snapshot_path
from ..utils import set_solver_precision
from . import card_name

EIG = ("eig_solve_tile", "eig_solve_rows")
KERNEL_A = ("substage_planes", "substage_kernel", "divergence_kernel")
PLAN_FIELDS = ("tc", "rt", "slab", "stages", "resident", "blocks",
               "zero_blocks", "warps")


def forced_plans(n: int, F2: int, B: int, sms: int):
    """{route name: plan} for the bordered eigen-solve of B envs: the
    warp-owned kernel (the rule's plan with the row-owned kernel's tiles
    declared not to fit) and the row-owned kernel at both tile widths."""
    from ..envs import tile_plan
    fits = tile_plan.eig_rows_smem_bytes
    tile_plan.eig_rows_smem_bytes = lambda n, tc: tile_plan.MAX_DYNAMIC_SMEM + 1
    try:
        warp = tile_plan.eig_plan(n, n - 1, B, F2, sms)
    finally:
        tile_plan.eig_rows_smem_bytes = fits
    columns = B * (F2 - 2)
    rows = {f"row-owned, tiles of {tc}": tile_plan.EigPlan(
        tc, 0, 0, 0, 0, -(-columns // tc), min(2 * B, sms), 0)
        for tc in (8, 16)}
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
    res = {"card": card_name()}
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

        row = {"eig_us": device_us(run_b, EIG),
               "kernel_a_us": device_us(run_a, KERNEL_A)}
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
