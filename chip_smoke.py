"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero, printing no
result):
  1. the device: CUDA present, the card's name and power limit;
  2. the kernel build from pde_policylearning_torch/csrc (nvcc, sm_90a);
  3. every kernel of the main path against its plain torch version on the
     card, at the main path's shapes (32x130x32, the packaged Re_tau~180
     snapshot, float32, TF32 off), with its error, both times (CUDA
     events, median of several calls) and its bound on this card: the
     larger of its operations over 67 TFLOP/s (fp32 outside the tensor
     cores) and its bytes over 3.35 TB/s, both counted from the shapes as
     the function needs them (`work` below: the x/z transforms as FFTs),
     with the cost of the kernel as built beside it (the in-kernel FFTs'
     own count) and its time with the transforms forced onto the dense DFT
     products of a grid that is no power of two;
     the x/z transform kernels alone against the T2/Ti2 products and
     against float64 at 32x130x32, at 16x18x64 and at 24x18x20 (which
     takes the DFT products), B = 1 and 3, the route printed;
     Kernels A and B (the staged step, each substage) and the mass-flow
     kernels at B = 1 and B = 8, the whole staged step and kernel D at
     B = 8, and kernel C (the batched wall pressures, B = 8), from the
     developed states of 50 kernel-D steps; the eigen-solve kernel and
     kernel A's stencil pass alone at B = 1 and B = 8 (device time per
     launch from torch.profiler, beside their bounds); the staged step
     against kernel D over three steps; the Poisson kernel, kernel A and
     kernel B on three small ragged grids, on a plane that is no multiple
     of 16 bytes (kernel A's point-by-point pass), on 8x258x8 (a basis that
     does not fit shared memory and is streamed) and on 2x1455x2 (taller
     than the row-owned eigen-solve takes), the eigen-solve's route
     printed; the gradient through projection_step on
     the card against the plain version's; env_step with a state that
     needs a gradient, and the rollouts refusing one;
     the fused corner entry (gather, contraction and scatter in one
     launch) against its plain version at the observer's serving shape
     (B 1, 32 x 17 spectrum, 2 x 6 x 6 modes, I = O = 32), its training
     batch (B 20), the legacy weight layout, ragged and wide shapes:
     forward, the gradient to x (the adjoint entry) and the gradients
     through its autograd Function; the strided entry behind
     `corner_contract` at its four shapes with its gradients;
     `spectral_conv_nd` (also with output sizes other than the input's)
     and the full-width
     `FNO2dObserver(12, 12, 32)` (forward, and the gradient to its input)
     kernel route against plain route, and a 20-step `fno` closed loop on
     both routes;
  4. the main path: NSControlEnv(32, 130, 32, noise 0.05, seed 0) with the
     opposition policy, run_closed_loop for 2000 steps once to warm up and
     three timed runs; the kernels' launch counts over exactly that run;
  5. the data-collection path: batched_rollout of 8 envs for 500 `gt`
     steps through kernel D and through the staged kernels
     (PDE_RK3_FULLSTEP=0), one warm-up and three timed runs each, the
     staged kernels' launch counts over exactly the last staged run; then
     generate_channel_dataset for 100 steps into a temporary directory,
     read back with PDEDataset.from_folder for its normalizers;
  6. the observer-policy path at full width: FNO2dObserver(12, 12, 32)
     with weights from a seeded generator on the card, make_policy('fno',
     action_scale 0.3, action_clip 0.01) and run_closed_loop for 2000
     steps, then make_policy('optimal-observer', opt_steps 10) for 200
     steps, one warm-up and three timed runs each; the fused corner
     entry's launch count over exactly one timed run must be 4 per `fno`
     step and 80 per `optimal-observer` step.
The line before the last is the per-kernel JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time


def log(msg):
    print(msg, flush=True)


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


FAILED = []


def check(name, err, tol):
    """Record a failed comparison; every phase runs, and the script fails
    at the end if any check did."""
    ok = err <= tol
    log(f"  {name}: rel L2 {err:.3e} (tolerance {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(f"{name}: {err:.3e} > {tol:g}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of one call in ms, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_us(fn, names, reps=10):
    """Device time per launch in us of the kernels whose name holds one of
    `names`, from torch.profiler over `reps` calls of fn, and their launches
    per call."""
    import torch
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
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(n in e.key for n in names)]
    count = sum(e.count for e in hits)
    if not count:
        raise AssertionError(f"no device kernel named like {names} ran")
    return (sum(e.self_device_time_total for e in hits) / count,
            count / reps)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from pde_policylearning_torch.control import make_policy, run_closed_loop
    from pde_policylearning_torch.control.loop import SCOREBOARD_KEYS
    from pde_policylearning_torch.data import (PDEDataset,
                                               generate_channel_dataset)
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.envs import poisson_cuda as pc
    from pde_policylearning_torch.envs import rk3_cuda as rk
    from pde_policylearning_torch.envs import tile_plan, xz_fft
    from pde_policylearning_torch.envs.control_env import \
        default_snapshot_path
    from pde_policylearning_torch.models import FNO2dObserver
    from pde_policylearning_torch.native import cuda_build
    from pde_policylearning_torch.ops import factorized, fourier
    from pde_policylearning_torch.ops import spectral_cuda as sc
    from pde_policylearning_torch.utils import set_solver_precision

    # 1. device -------------------------------------------------------------
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    set_solver_precision()

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_build.build_seconds:.1f} s) -> "
        f"{cuda_build.library_path().name}")
    regs = [int(w.split()[0]) for w in
            cuda_build.build_log.split("Used ")[1:]]
    spills, fn_name = [], "?"
    for ln in cuda_build.build_log.splitlines():
        if "Function properties for" in ln:
            fn_name = ln.split("Function properties for")[1].strip()
        elif "spill" in ln and " 0 bytes spill stores" not in ln:
            spills.append(f"{fn_name}: {ln.strip()}")
    log(f"  ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
        f"registers, spilling: {spills or 'none'}")

    # 3. kernels against their plain versions -------------------------------
    Nx, Ny, Nz, dp = 32, 130, 32, 25
    C = Nx * Nz
    grid = cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, device=dev)
    snap = np.load(default_snapshot_path())
    state = cf.init_state(grid, U=snap["U"], V=snap["V"], W=snap["W"],
                          dPdx=float(snap["dPdx"]))
    kst = rk.state_to_kstate(state)
    report = {}
    xz_report = {}

    # the card's published peaks: fp32 outside the tensor cores, HBM3
    PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
    n, m = Ny - 1, Ny - 2
    F2 = 2 * Nx * (Nz // 2 + 1)
    field = (Ny + 1) * C          # one U or W field; V has one row less

    def gemm(M, N, K):
        return 2 * M * N * K

    def work(name, B=1, as_built=False):
        """(operations, bytes) of one call of an env kernel for B envs,
        from the shapes: what the function needs, not what the kernel
        spends.  The x/z transforms are 2-D real FFTs of Nx x Nz planes,
        2.5 N log2 N operations each for N = Nx Nz points (half the
        5 N log2 N of a complex FFT); the eigen-solve products are counted
        exactly; the stencil passes by the operations per point counted in
        csrc/common.cuh (momentum RHS of three fields 175, RK update 8,
        divergence 8, correction 10, residual 6).  Bytes: every input
        (state, actuation, the cached eigen-solve constants) read once,
        every output written once, 4 bytes each; scratch does not count.
        `as_built` counts the transforms as the kernels compute them: the
        in-kernel FFTs' own operations (`xz_fft.fft_flops`: radix-2
        butterflies, two real rows a complex transform) and their twiddle
        tables, or, with `as_built="dft"`, the dense products with the
        (Nx Nz, F2) Kronecker DFT matrices, which are then inputs too; and
        kernel A's plane pass with the V row that each block computes
        again for its divergence (58 of the 175 operations per point, one
        row in `tile_plan.substage_rows`).  The kernels' own cost, no
        bound."""
        refine = grid.refine_steps
        mode00 = 2 * gemm(n, 1, n)           # Pinv00 on the re and im columns

        def fft2(rows, forward=True):        # `rows` planes, either direction
            if as_built == "dft":
                return gemm(rows, F2, C) if forward else gemm(rows, C, F2)
            if as_built:
                return rows * xz_fft.fft_flops(Nx, Nz)
            return rows * 2.5 * C * math.log2(C)

        def solve(k):                        # eig_solve passes, k-row basis
            return ((1 + refine) * (2 * gemm(k, F2, k) + mode00)
                    + refine * 6 * n * F2)

        def spectral(k):                     # transform, solve, synthesis
            return fft2(n) + solve(k) + fft2(n, False)

        state = 2 * field + Ny * C           # U, V, W
        # one DFT matrix (T2 or Ti2), or the two twiddle tables
        dft = {"dft": C * F2, True: Nx + Nz}.get(as_built, 0)
        bordered = 2 * m * m + 2 * m * F2 + n * n   # A1, B1, denom1, g, Pinv00
        walls = 3 * m + 3 * F2                      # A13, g3
        fwd = (175 + 8) * field + fft2(n)
        bsolve = (mode00 + gemm(m, F2, m) + gemm(3, F2, m) + 12 * F2
                  + fft2(2, False))
        sub = (175 + 8) * field + 8 * n * C
        rows_a = tile_plan.substage_rows(B, Ny, C)
        if as_built and rows_a:
            sub += 58 * -(-n // rows_a) * C
        cor = spectral(m) + 10 * field
        # (operations per env, words per env, words of shared constants)
        flops, per_env, shared = {
            "poisson": (spectral(n), 2 * n * C,
                        2 * dft + 3 * n * n + n * F2),
            "boundary_fwd": (fwd, state + n * F2, dft),
            "boundary_solve": (bsolve, n * F2 + 2 * C,
                               m * m + m * F2 + walls + n * n + dft),
            # stage 1: U0, V0, W0 are U, V, W; the RHS fields are written
            "rk3_substage": (sub, state + 2 * C + 2 * state + n * C, 0),
            "rk3_solve_correct": (cor, n * C + 2 * state + 2 * C,
                                  2 * dft + bordered),
            "rk3_fullstep": (3 * (sub + cor) + 3 * n * C + fwd + bsolve,
                             2 * state + 4 * C,
                             2 * dft + bordered + walls),
            "boundary_batched": (fwd + bsolve, state + 2 * C,
                                 2 * dft + m * m + m * F2 + walls
                                 + n * n),
        }[name]
        return B * flops, 4 * (B * per_env + shared)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def entry(name, source, replaces, out, ref, fn_kernel, fn_plain,
              flops_bytes, fn_library=None, as_built=None, dft_B=0):
        out, ref = zip(*((a, b) for a, b in zip(out, ref) if b is not None))
        bound_ms, bound_by = bound(*flops_bytes)
        report[name] = dict(
            name=name, route="cuda",
            source=f"pde_policylearning_torch/csrc/{source}",
            replaces=f"pde_policylearning_tpu/{replaces}",
            max_abs_err=max(float((a.double() - b.double()).abs().max())
                            for a, b in zip(out, ref)),
            ms=cuda_ms(fn_kernel), plain_ms=cuda_ms(fn_plain),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms(fn_library) if fn_library else None,
            operations=flops_bytes[0], bytes=flops_bytes[1])
        r = report[name]
        if as_built:                    # the kernel's own cost, no bound
            r["operations_as_built"], r["bytes_as_built"] = as_built
            r["as_built_ms"] = bound(*as_built)[0]
        if dft_B:   # the same entry of dft_B envs, transforms as products
            rk.kernel_args(grid, dft_B, fft=False)
            r["ms_dft_products"] = cuda_ms(fn_kernel)
            rk.kernel_args(grid, dft_B, fft=True)
            log(f"  {name}: {r['ms_dft_products']:.4f} ms with the "
                "transforms forced onto the DFT products")
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.5f} ms by {bound_by}, library "
            f"{r['library_ms']}), max abs err {r['max_abs_err']:.3e}; "
            f"{flops_bytes[0] / 1e6:.3f} MFLOP, {flops_bytes[1] / 1e6:.3f} "
            "MB" + (f"; as built {as_built[0] / 1e6:.3f} MFLOP, "
                    f"{as_built[1] / 1e6:.3f} MB" if as_built else ""))

    log("x/z transforms alone: kernels against the T2/Ti2 products and "
        "against float64")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for shape in ((Nx, Ny, Nz), (16, 18, 64), (24, 18, 20)):
        g32 = grid if shape == (Nx, Ny, Nz) else cf.make_channel_grid(
            *shape, device=dev)
        g64 = cf.make_channel_grid(*shape, device=dev, dtype=torch.float64)
        gx, gy, gz = shape
        for B in (1, 3):
            route = "fft" if xz_fft.fft_route(gx, gz) else "dft"
            # the kernels run the route whose constants they were given
            given = rk.kernel_args(g32, B).tensors
            if ("twx" in given) != (route == "fft") or \
                    ("T2" in given) == (route == "fft"):
                FAILED.append(f"{shape}: the kernels' constants are not "
                              f"those of the {route} route")
            Y = torch.randn((gy - 1, B * gx * gz), generator=gen, device=dev)
            P = torch.randn((B, gy - 1, 2 * gx * (gz // 2 + 1)),
                            generator=gen, device=dev)
            for nm, a, kern, plain, exact in (
                    ("forward", Y, lambda a: rk.xz_forward_kernel(g32, B, a),
                     lambda a: rk.xz_forward_plain(g32, B, a),
                     lambda a: rk.xz_forward_plain(g64, B, a)),
                    ("inverse", P, lambda a: rk.xz_inverse_kernel(g32, a),
                     lambda a: rk.xz_inverse_plain(g32, a),
                     lambda a: rk.xz_inverse_plain(g64, a))):
                out, ref, ex = kern(a), plain(a), exact(a.double())
                torch.cuda.synchronize()
                e_k, e_p = rel(out, ex), rel(ref, ex)
                log(f"  {gx}x{gy}x{gz} B={B} {nm}, route {route}: against "
                    f"float64 kernel {e_k:.3e}, product {e_p:.3e}")
                # one fp32 sum of Nx Nz terms in another order
                check(f"{gx}x{gy}x{gz} B={B} {nm}: kernel against product",
                      rel(out, ref), 2e-6)
                if route == "fft" and e_k > e_p:
                    FAILED.append(
                        f"{gx}x{gy}x{gz} B={B} {nm}: the FFT kernel is "
                        f"further from float64 ({e_k:.3e}) than the "
                        f"product ({e_p:.3e})")
            if shape == (Nx, Ny, Nz) and B == 1:
                rows = Ny - 1
                xz_report = dict(
                    forward_ms=cuda_ms(
                        lambda: rk.xz_forward_kernel(g32, 1, Y)),
                    inverse_ms=cuda_ms(lambda: rk.xz_inverse_kernel(g32, P)),
                    forward_plain_ms=cuda_ms(
                        lambda: rk.xz_forward_plain(g32, 1, Y)),
                    inverse_plain_ms=cuda_ms(
                        lambda: rk.xz_inverse_plain(g32, P)),
                    library_ms=cuda_ms(lambda: torch.fft.fft(
                        torch.fft.rfft(Y.reshape(rows, gx, gz)), dim=1)),
                    bound_ms=bound(rows * 2.5 * C * math.log2(C),
                                   4 * rows * (C + F2))[0])
                rk.kernel_args(g32, 1, fft=False)
                xz_report["forward_ms_dft_products"] = cuda_ms(
                    lambda: rk.xz_forward_kernel(g32, 1, Y))
                xz_report["inverse_ms_dft_products"] = cuda_ms(
                    lambda: rk.xz_inverse_kernel(g32, P))
                rk.kernel_args(g32, 1, fft=True)
                log(f"  {rows} planes of {gx}x{gz}, one wrapper call, ms: "
                    f"{json.dumps(xz_report)}")

    log("poisson (env construction: cal_pressure right-hand side)")
    rhs = cf._pressure_rhs(grid, state)
    out = pc.poisson_solve_kernel(grid, rhs)
    ref = pc.poisson_solve_plain(grid, rhs)
    # tolerance of the JAX kernel's own test against its reference path;
    # both f32 solves are also held against a float64 solve
    check("p", rel(out, ref), 2e-4)
    grid64 = cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, device=dev,
                                  dtype=torch.float64)
    exact = pc.poisson_solve_plain(grid64, rhs.double())
    log(f"  against float64: kernel {rel(out, exact):.3e}, "
        f"plain {rel(ref, exact):.3e}")
    entry("poisson", "poisson.cu", "envs/poisson_pallas.py:76", [out], [ref],
          lambda: pc.poisson_solve_kernel(grid, rhs),
          lambda: pc.poisson_solve_plain(grid, rhs), work("poisson"),
          as_built=work("poisson", as_built=True), dft_B=1)

    log("boundary pair (first observation)")
    dP1 = state.dPdx.reshape(1)
    t_k = rk.boundary_fwd_kernel(grid, kst.U, kst.V, kst.W, dP1)
    t_p = rk.boundary_fwd_plain(grid, kst.U, kst.V, kst.W, dP1)
    check("t (forward)", rel(t_k, t_p), 2e-5)
    p_k = rk.boundary_solve_kernel(grid, t_p)
    p_p = rk.boundary_solve_plain(grid, t_p)
    check("p1", rel(p_k[0], p_p[0]), 2e-5)
    check("p2", rel(p_k[1], p_p[1]), 2e-5)
    entry("boundary_fwd", "boundary.cu", "envs/rk3_pallas.py:351", [t_k],
          [t_p],
          lambda: rk.boundary_fwd_kernel(grid, kst.U, kst.V, kst.W, dP1),
          lambda: rk.boundary_fwd_plain(grid, kst.U, kst.V, kst.W, dP1),
          work("boundary_fwd"),
          as_built=work("boundary_fwd", as_built=True), dft_B=1)
    entry("boundary_solve", "boundary.cu", "envs/rk3_pallas.py:408", [p_k],
          [p_p], lambda: rk.boundary_solve_kernel(grid, t_p),
          lambda: rk.boundary_solve_plain(grid, t_p), work("boundary_solve"),
          as_built=work("boundary_solve", as_built=True), dft_B=1)

    def step_args(states):
        def cat(name):
            return torch.cat([getattr(s, name) for s in states],
                             1).contiguous()
        ops = [cf.gt_control(s, dp) for s in states]
        return (grid, len(states), cat("U"), cat("V"), cat("W"),
                torch.stack([s.dPdx for s in states]),
                torch.stack([s.meanU0 for s in states]),
                torch.cat([o[0] for o in ops])[None].contiguous(),
                torch.cat([o[1] for o in ops])[None].contiguous())

    def run_steps(step, st, n):
        rows, states = [], []
        for _ in range(n):
            U, V, W, dPdx, p = step(*step_args([st]))
            st = st.replace(U=U, V=V, W=W, dPdx=dPdx.reshape(()))
            states.append(st)
            p2 = p[1].reshape(Nx, Nz)
            info = rk.step_metrics_k(grid, st, p2)
            rows.append(torch.stack([info[k] for k in SCOREBOARD_KEYS]))
        return st, p2, torch.stack(rows, 1), states

    log("kernel D, 50 gt steps from the snapshot")
    st_k, p2_k, s_k, _ = run_steps(rk.env_step_full_kb_kernel, kst, 50)
    st_p, p2_p, s_p, states_p = run_steps(rk.env_step_full_kb_plain, kst,
                                          50)
    for name in ("U", "V", "W"):
        check(f"50-step {name}", rel(getattr(st_k, name),
                                     getattr(st_p, name)), 1e-5)
    check("50-step p2", rel(p2_k, p2_p), 5e-4)
    s_k, s_p = s_k.cpu().double().numpy(), s_p.cpu().double().numpy()
    for i, k in enumerate(SCOREBOARD_KEYS):
        # -|sum(div)| of a projected field is the sum of ~1.3e5 cells of
        # float32 projection residual (~1e-3 at this grid, either version),
        # so it takes an absolute bound only; the guard trips at 10
        atol = 1e-2 if "divergence" in k else 1e-6
        worst = float(np.max((np.abs(s_k[i] - s_p[i]) - atol)
                             / np.abs(s_p[i])))
        log(f"  50-step {k}: kernel {s_k[i, -1]:.6e} plain {s_p[i, -1]:.6e} "
            f"worst rel {max(worst, 0.0):.3e} (rtol 5e-3, atol {atol:g})")
        if worst > 5e-3:
            FAILED.append(f"50-step {k}: worst rel {worst:.3e} > 5e-3")

    log("kernel D, one step")

    def f64_errors(args, out, ref):
        a64 = [a.double() if torch.is_tensor(a) else a for a in args]
        a64[0] = grid64
        exact = rk.env_step_full_kb_plain(*a64)
        return {nm: (rel(o, e), rel(r, e)) for nm, o, r, e in zip(
            ("U", "V", "W", "p2"), (*out[:3], out[4][1]),
            (*ref[:3], ref[4][1]), (*exact[:3], exact[4][1]))}

    # the first controlled step from the snapshot switches the actuation
    # on; there both float32 versions sit ~2e-5 (V) and ~6e-5 (p2) from a
    # float64 step, so each is held against float64 instead of each other
    args0 = step_args([kst])
    errs = f64_errors(args0, rk.env_step_full_kb_kernel(*args0),
                      rk.env_step_full_kb_plain(*args0))
    for nm, (e_k, e_p) in errs.items():
        log(f"  first step, {nm} against float64: kernel {e_k:.3e} "
            f"plain {e_p:.3e}")
        check(f"first step {nm}: kernel/plain error against float64",
              e_k / e_p, 2.0)
    # from the developed states after 50 steps: kernel against plain
    for states in ([st_p], [st_p, st_k]):
        args = step_args(states)
        out = rk.env_step_full_kb_kernel(*args)
        ref = rk.env_step_full_kb_plain(*args)
        B = len(states)
        check(f"B={B} U", rel(out[0], ref[0]), 2e-6)
        check(f"B={B} V", rel(out[1], ref[1]), 2e-5)
        check(f"B={B} W", rel(out[2], ref[2]), 2e-5)
        check(f"B={B} p2", rel(out[4][1], ref[4][1]), 2e-5)
        check(f"B={B} dPdx", rel(out[3], ref[3]), 5e-3)
        if B == 1:
            args1, out1, ref1 = args, out, ref
            log("  against float64: " + ", ".join(
                f"{nm} kernel {e_k:.3e} plain {e_p:.3e}" for nm, (e_k, e_p)
                in f64_errors(args, out, ref).items()))
    entry("rk3_fullstep", "rk3_fullstep.cu", "envs/rk3_pallas.py:1058",
          out1, ref1, lambda: rk.env_step_full_kb_kernel(*args1),
          lambda: rk.env_step_full_kb_plain(*args1), work("rk3_fullstep"),
          as_built=work("rk3_fullstep", as_built=True), dft_B=1)

    def check_stages(args, tag):
        """Kernels A and B on each substage and the mass-flow kernels
        against their plain versions, each stage fed the plain outputs of
        the stage before; returns stage 1's (args, kernel, plain) of A and
        of B."""
        _, B, U0, V0, W0, dP, mU, op1, op2 = args
        Uc, Vc, Wc, F1 = U0, V0, W0, None
        for i, (c_cur, c_prev) in enumerate(rk._RK3_STAGES):
            a_args = (grid, B, Uc, Vc, Wc, U0, V0, W0, F1, op1, op2, dP,
                      c_cur, c_prev, i == 0)
            out_a = rk.substage_kernel(*a_args)
            ref_a = rk.substage_plain(*a_args)
            for nm, o, r in zip(("Un", "Vn", "Wn", "div", "Fu", "Fv", "Fw"),
                                out_a, ref_a):
                if r is not None:
                    check(f"{tag} A stage {i + 1} {nm}", rel(o, r), 1e-6)
            b_args = (grid, B, ref_a[3], *ref_a[:3], op1, op2)
            out_b = rk.solve_correct_kernel(*b_args)
            ref_b = rk.solve_correct_plain(*b_args)
            for nm, o, r, tol in zip("UVW", out_b, ref_b, (2e-6, 2e-5, 2e-5)):
                check(f"{tag} B stage {i + 1} {nm}", rel(o, r), tol)
            if i == 0:
                F1 = ref_a[4:]
                first = (a_args, out_a, ref_a), (b_args, out_b, ref_b)
            Uc, Vc, Wc = ref_b
        U_mk, dP_mk = rk.mass_flow_kernel(grid, B, Uc.clone(), mU, dP)
        U_mp, dP_mp = rk.mass_flow_plain(grid, B, Uc, mU, dP)
        check(f"{tag} mass flow U", rel(U_mk, U_mp), 1e-7)
        check(f"{tag} mass flow dPdx", rel(dP_mk, dP_mp), 1e-6)
        return first

    def check_steps(args, tag):
        """The staged step and kernel D against their plain versions, with
        kernel D's one-step bounds."""
        for nm, step, plain in (
                ("staged step", rk.rk3_step_kb, rk.rk3_step_kb_plain),
                ("kernel D", rk.env_step_full_kb_kernel,
                 rk.env_step_full_kb_plain)):
            out, ref = step(*args), plain(*args)
            pairs = [("U", 2e-6), ("V", 2e-5), ("W", 2e-5), ("dPdx", 5e-3)]
            for j, (q, tol) in enumerate(pairs):
                check(f"{tag} {nm} {q}", rel(out[j], ref[j]), tol)
            if len(out) == 5:
                check(f"{tag} {nm} p2", rel(out[4][1], ref[4][1]), 2e-5)

    built, needed = (report["rk3_fullstep"]["operations_as_built"],
                     report["rk3_fullstep"]["operations"])
    log(f"  kernel D operations as built {built / 1e9:.4f} GFLOP, the "
        f"function's {needed / 1e9:.4f} GFLOP ({built / needed:.3f}x)")
    if built > 1.3 * needed:
        FAILED.append(f"kernel D as built does {built / needed:.2f}x the "
                      "function's operations (limit 1.3x)")

    log("kernels A and B, each substage, from the state after 50 steps")
    a0, b0 = check_stages(args1, "B=1")
    # kernel A is bitwise the plain version on the card (every term rounds
    # as torch's does; the build keeps fmad off)
    worst_a = max(float((o - r).abs().max()) for o, r in zip(a0[1], a0[2])
                  if r is not None)
    log(f"  kernel A, stage 1, B=1: max abs error {worst_a:.3e}")
    entry("rk3_substage", "rk3_staged.cu", "envs/rk3_pallas.py:199", a0[1],
          a0[2], lambda: rk.substage_kernel(*a0[0]),
          lambda: rk.substage_plain(*a0[0]), work("rk3_substage"),
          as_built=work("rk3_substage", as_built=True))
    entry("rk3_solve_correct", "rk3_staged.cu", "envs/rk3_pallas.py:319",
          b0[1], b0[2], lambda: rk.solve_correct_kernel(*b0[0]),
          lambda: rk.solve_correct_plain(*b0[0]), work("rk3_solve_correct"),
          as_built=work("rk3_solve_correct", as_built=True), dft_B=1)

    # phase 5 runs every kernel at B = 8 (packed columns, per-env dPdx and
    # mass flow); hold each one there too
    log("B=8 (the last 8 states of the 50-step run): kernels A, B, the "
        "mass flow, the staged step, kernel D, kernel C")
    args8 = step_args(states_p[-8:])
    a8, b8 = check_stages(args8, "B=8")
    check_steps(args8, "B=8")

    log("the eigen-solve kernel and kernel A's pass alone: device us per "
        "launch (torch.profiler) beside the bound")
    alone = {}
    for Bn, (a_case, b_case) in ((1, (a0, b0)), (8, (a8, b8))):
        plan = tile_plan.eig_plan(n, m, Bn, F2)
        rows_a = tile_plan.substage_rows(Bn, Ny, C)
        route = (f"row-owned, tiles of {plan.tc}" if plan.tc else
                 f"warp-owned, {plan.warps} warps, "
                 f"{'resident' if plan.resident else 'streamed'} basis")
        refine = grid.refine_steps
        tile_work = (Bn * ((1 + refine) * (2 * gemm(m, F2, m)
                                           + 2 * gemm(n, 1, n))
                           + refine * 6 * n * F2),
                     4 * (2 * Bn * n * F2 + 2 * m * m + 2 * m * F2 + n * n))
        tile_us, tile_n = device_us(
            lambda: rk.solve_correct_kernel(*b_case[0]),
            ("eig_solve_tile", "eig_solve_rows"))
        a_us, a_n = device_us(
            lambda: rk.substage_kernel(*a_case[0]),
            ("substage_planes", "substage_kernel", "divergence_kernel"))
        if tile_n != 1 or a_n != (1 if rows_a else 2):
            FAILED.append(f"B={Bn}: {tile_n} eigen-solve launches per solve "
                          f"and {a_n} of kernel A per substage")
        alone[f"B{Bn}"] = dict(
            eig_route=route, eig_device_us=tile_us,
            eig_bound_us=1e3 * bound(*tile_work)[0],
            kernel_a_rows_per_block=rows_a, kernel_a_device_us=a_us * a_n,
            kernel_a_bound_us=1e3 * bound(*work("rk3_substage", Bn))[0])
        log(f"  B={Bn}: {json.dumps(alone[f'B{Bn}'])}")
    report["rk3_solve_correct"]["eig_kernel_alone"] = {
        k: {q: v[q] for q in v if q.startswith("eig")}
        for k, v in alone.items()}
    report["rk3_substage"]["pass_alone"] = {
        k: {q: v[q] for q in v if q.startswith("kernel_a")}
        for k, v in alone.items()}
    _, B8, U8, V8, W8, dP8, _, _, _ = args8
    p_k = rk.boundary_kernel(grid, U8, V8, W8, dP8)
    p_p = rk.boundary_solve_plain(grid, rk.boundary_fwd_plain(grid, U8, V8,
                                                              W8, dP8))
    check("B=8 p1", rel(p_k[0], p_p[0]), 2e-5)
    check("B=8 p2", rel(p_k[1], p_p[1]), 2e-5)
    entry("boundary_batched", "boundary.cu", "envs/rk3_pallas.py:426", [p_k],
          [p_p], lambda: rk.boundary_kernel(grid, U8, V8, W8, dP8),
          lambda: rk.boundary_solve_plain(grid, rk.boundary_fwd_plain(
              grid, U8, V8, W8, dP8)), work("boundary_batched", B8),
          as_built=work("boundary_batched", B8, as_built=True), dft_B=B8)

    log("other grids: the Poisson kernel, kernel A and kernel B where the "
        "eigen-solve's columns straddle envs and end ragged (3x9x4: 16 tile "
        "columns per env; 2x6x2: 2), on a plane of 9 floats (3x9x3: kernel "
        "A point by point), with a streamed basis (8x258x8) and taller than "
        "the row-owned kernel's tiles (2x1455x2)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for shape in ((3, 9, 4), (2, 6, 2), (24, 18, 20), (3, 9, 3), (8, 258, 8),
                  (2, 1455, 2)):
        gs = cf.make_channel_grid(*shape, device=dev)
        gx, gy, gz = shape
        rhs_s = torch.randn((gx, gy - 1, gz), generator=gen, device=dev)
        rhs_s = rhs_s - rhs_s.mean()
        out_s = pc.poisson_solve_kernel(gs, rhs_s)
        ref_s = pc.poisson_solve_plain(gs, rhs_s)
        if gy <= 130:
            check(f"{gx}x{gy}x{gz} poisson", rel(out_s, ref_s), 2e-4)
        else:
            # a random right-hand side on a tall graded mesh: both float32
            # solves sit ~1e-4 .. 1e-3 from a float64 one, so each is held
            # against float64 and not against the other
            g64 = cf.make_channel_grid(*shape, device=dev,
                                       dtype=torch.float64)
            exact = pc.poisson_solve_plain(g64, rhs_s.double())
            e_k, e_p = rel(out_s, exact), rel(ref_s, exact)
            log(f"  {gx}x{gy}x{gz} poisson against float64: kernel "
                f"{e_k:.3e} plain {e_p:.3e}")
            check(f"{gx}x{gy}x{gz} poisson: kernel/plain error against "
                  "float64", e_k / e_p, 2.0)
        for B in (1, 3):
            cols = B * gx * gz
            plans = [tile_plan.eig_plan(gy - 1, K, B, 2 * gx * (gz // 2 + 1))
                     for K in (gy - 1, gy - 2)]
            log(f"  {gx}x{gy}x{gz} B={B}: eigen-solve plans {plans}, kernel A "
                f"rows per block {tile_plan.substage_rows(B, gy, gx * gz)}")

            def rnd(rows):
                return torch.randn((rows, cols), generator=gen, device=dev)
            b_args = (gs, B, 0.01 * rnd(gy - 1), rnd(gy + 1), rnd(gy),
                      rnd(gy + 1), rnd(1), rnd(1))
            for nm, o, r in zip("UVW", rk.solve_correct_kernel(*b_args),
                                rk.solve_correct_plain(*b_args)):
                check(f"{gx}x{gy}x{gz} B={B} kernel B {nm}", rel(o, r), 2e-5)
            # kernel A: stage 1 with the RHS written, stage 2 on F1
            U0, V0, W0 = rnd(gy + 1), rnd(gy), rnd(gy + 1)
            dP = torch.randn(B, generator=gen, device=dev)
            a1 = (gs, B, U0, V0, W0, U0, V0, W0, None, rnd(1), rnd(1), dP,
                  *rk._RK3_STAGES[0], True)
            ref1 = rk.substage_plain(*a1)
            a2 = (gs, B, rnd(gy + 1), rnd(gy), rnd(gy + 1), U0, V0, W0,
                  ref1[4:], a1[9], a1[10], dP, *rk._RK3_STAGES[1], False)
            for tag, a_args, ref_a in (("stage 1", a1, ref1),
                                       ("stage 2", a2,
                                        rk.substage_plain(*a2))):
                out_a = rk.substage_kernel(*a_args)
                worst = max(rel(o, r) for o, r in zip(out_a, ref_a)
                            if r is not None)
                check(f"{gx}x{gy}x{gz} B={B} kernel A {tag}", worst, 1e-6)

    log("staged step (rk3_step_k + wall pair) against kernel D, 3 steps")
    sa = sb = st_p
    for _ in range(3):
        _, _, U, V, W, dP, mU, o1, o2 = step_args([sa])
        U, V, W, dPa = rk.rk3_step_k(grid, U, V, W, dP, mU, o1, o2)
        sa = sa.replace(U=U, V=V, W=W, dPdx=dPa.reshape(()))
        p2a = rk.boundary_pressures_k(grid, U, V, W, dPa)[1]
        U, V, W, dPb, p = rk.env_step_full_kb_kernel(*step_args([sb]))
        sb = sb.replace(U=U, V=V, W=W, dPdx=dPb.reshape(()))
        p2b = p[1:2]
    check("staged/kernel D U", rel(sa.U, sb.U), 1e-5)
    check("staged/kernel D V", rel(sa.V, sb.V), 1e-4)
    check("staged/kernel D p2", rel(p2a, p2b), 1e-4)

    log("gradient through projection_step on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    weights = [torch.randn(a.shape, generator=gen, device=dev)
               for a in (state.U, state.V, state.W)]

    def projection_grads(project):
        fields = [a.clone().requires_grad_()
                  for a in (state.U, state.V, state.W)]
        out = project(*fields)
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        return torch.autograd.grad(loss, fields), out[0].grad_fn

    n0 = pc.poisson_solve_kernel.launches
    g_k, fn_k = projection_grads(
        lambda U, V, W: cf.projection_step(grid, U, V, W))
    if pc.poisson_solve_kernel.launches != n0 + 1 or fn_k is None:
        FAILED.append("projection_step on the card: kernel not launched "
                      "or no grad_fn")
    g_p, _ = projection_grads(lambda U, V, W: cf.pressure_correction(
        grid, U, V, W, pc.poisson_solve_plain(grid, cf.divergence(
            grid, U, V, W))))
    for nm, a, b in zip("UVW", g_k, g_p):
        check(f"grad {nm}", rel(a, b), 1e-5)

    log("env_step with a state that needs a gradient (staged kernels in "
        "rk3_step's Function); the rollouts refuse such a state")
    ops0 = cf.gt_control(state, dp)
    U_req = state.U.clone().requires_grad_()
    n0 = rk.substage_kernel.launches
    st_g, p2_g, _, _ = cf.env_step(grid, state.replace(U=U_req), *ops0)
    (g_U,) = torch.autograd.grad(st_g.U.sum() + p2_g.sum(), U_req)
    if rk.substage_kernel.launches != n0 + 3 or not torch.isfinite(g_U).all():
        FAILED.append("env_step with grad: staged kernels not launched 3 "
                      "times or non-finite gradient")
    st_n, p2_n, _, _ = cf.env_step(grid, state, *ops0)   # kernel D
    check("env_step with grad against without: U", rel(st_g.U, st_n.U), 1e-5)
    check("env_step with grad against without: p2", rel(p2_g, p2_n), 1e-4)
    try:
        cf.rollout(grid, state.replace(U=U_req), 1)
        FAILED.append("rollout on the card took a state that needs a "
                      "gradient")
    except RuntimeError as e:
        if "passes no gradient" not in str(e):
            raise

    log("corner contraction (the observer's spectral convolutions)")

    def corner_inputs(R, B, M2, I, O, seed=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return [torch.randn(sh, generator=g, device=dev) for sh in
                [(R, B, M2, I), (R, B, M2, I), (R, M2, I, O), (R, M2, I, O)]]

    def corner_work(R, B, M2, I, O):
        return (8 * R * M2 * B * I * O,
                4 * (2 * R * B * M2 * I + 2 * R * M2 * I * O
                     + 2 * R * B * M2 * O))

    def corner_grads(fn, args):
        args = [a.clone().requires_grad_() for a in args]
        or_, oi_ = fn(*args)
        return torch.autograd.grad((or_ ** 2).sum() + (or_ * oi_).sum(), args)

    serving, training = (12, 1, 6, 32, 32), (12, 20, 6, 32, 32)
    log("  the strided entry behind corner_contract (the weight gradient)")
    # one fp32 sum of <= 64 terms taken in another order
    strided = {}
    for tag, shape in (("serving B=1", serving), ("training B=20", training),
                       ("ragged", (4, 3, 3, 5, 6)),
                       ("large", (24, 64, 12, 64, 64))):
        args = corner_inputs(*shape)
        out = sc.corner_contract_kernel(*args)
        torch.cuda.synchronize()
        ref = sc.corner_contract_plain(*args)
        check(f"corner {tag} or", rel(out[0], ref[0]), 2e-6)
        check(f"corner {tag} oi", rel(out[1], ref[1]), 2e-6)
        if shape in (serving, training):
            n0 = sc.corner_contract_kernel.launches
            g_k = corner_grads(sc.corner_contract, args)
            if sc.corner_contract_kernel.launches != n0 + 3:
                FAILED.append(f"corner {tag}: forward + dx + dw should be 3 "
                              "launches")
            g_p = corner_grads(sc.corner_contract_plain, args)
            for nm, a, b in zip(("dxr", "dxi", "dwr", "dwi"), g_k, g_p):
                check(f"corner {tag} {nm}", rel(a, b), 2e-6)
            x_c = torch.complex(args[0], args[1])
            w_c = torch.complex(args[2], args[3])
            strided[shape[1]] = dict(
                ms=cuda_ms(lambda: sc.corner_contract_kernel(*args)),
                bound_ms=bound(*corner_work(*shape))[0],
                bytes=corner_work(*shape)[1],
                library_ms=cuda_ms(lambda: torch.einsum(
                    "rbmi,rmio->rbmo", x_c, w_c)))
            log(f"  strided entry at B={shape[1]}: {strided[shape[1]]}")

    log("  the fused entry: corner gather, contraction and scatter in one "
        "launch, spectrum to spectrum")

    def spec_inputs(B, H, Wh, I, O, m1, m2, legacy, seed=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

        def rnd(*sh):
            return torch.randn(sh, generator=g, device=dev)
        x_ft = torch.complex(rnd(B, H, Wh, I), rnd(B, H, Wh, I))
        d_ft = torch.complex(rnd(B, H, Wh, O), rnd(B, H, Wh, O))
        ws = [{"tensor": rnd(2, I, O, m1, m2)} if legacy
              else {"mm2": rnd(2, m1, m2, I, O)} for _ in range(2)]
        return x_ft, d_ft, ws

    def spec_work(B, H, Wh, I, O, m1, m2):
        """The function as now defined: the two corners of the input
        spectrum in (the output depends on nothing else of it, and the
        kernel reads nothing else), the whole output spectrum out, both
        corners' weights, 8 bytes a complex64; 8 operations per complex
        multiply-add."""
        return (8 * B * 2 * m1 * m2 * I * O,
                8 * (B * 2 * m1 * m2 * I + B * H * Wh * O
                     + 2 * m1 * m2 * I * O))

    def spec_grads(fn, x_ft, ws, modes):
        x_ft = x_ft.clone().requires_grad_()
        leaves = [v.clone().requires_grad_() for w in ws for v in w.values()]
        o = fn(x_ft, [{k: v} for w, v in zip(ws, leaves) for k in w], modes)
        loss = (o.real ** 2).sum() + (o.real * o.imag).sum()
        return torch.autograd.grad(loss, [x_ft, *leaves])

    def cre(a):
        return torch.view_as_real(a) if a.is_complex() else a

    spec_serving = (1, Nx, Nz // 2 + 1, 32, 32, 6, 6)
    spec_training = (20, Nx, Nz // 2 + 1, 32, 32, 6, 6)
    for tag, shape, legacy in (
            ("serving B=1", spec_serving, False),
            ("training B=20", spec_training, False),
            ("legacy layout", (2, Nx, Nz // 2 + 1, 32, 32, 6, 6), True),
            ("ragged", (3, 9, 5, 5, 6, 4, 3), False),
            ("ragged, legacy", (3, 9, 5, 5, 7, 3, 5), True),
            ("wide", (2, 16, 9, 200, 300, 3, 4), False),
            ("all ones", (1, 2, 1, 1, 1, 1, 1), False)):
        x_ft, d_ft, ws = spec_inputs(*shape, legacy)
        modes = shape[5:]
        views = sc._dense_views(ws)
        out = sc.spectral_corners_kernel(x_ft, *views)
        dx = sc.spectral_corners_kernel(d_ft, *views, adjoint=True)
        torch.cuda.synchronize()
        ref = sc.spectral_corners_plain(x_ft, ws, modes)
        dref = sc.spectral_corners_plain(
            d_ft, [sc._adjoint_weight(v) for v in views], modes)
        check(f"fused corners {tag}: forward", rel(cre(out), cre(ref)), 2e-6)
        check(f"fused corners {tag}: dx (adjoint)", rel(cre(dx), cre(dref)),
              2e-6)
        if not bool(((out == 0) == (ref == 0)).all()):
            FAILED.append(f"fused corners {tag}: zeros are not where the "
                          "plain version has them")
        n0 = (sc.spectral_corners_kernel.launches,
              sc.corner_contract_kernel.launches)
        g_k = spec_grads(sc.spectral_corners, x_ft, ws, modes)
        n1 = (sc.spectral_corners_kernel.launches - n0[0],
              sc.corner_contract_kernel.launches - n0[1])
        if n1 != (2, 2):
            FAILED.append(f"fused corners {tag}: forward + dx should be 2 "
                          f"launches and dw 2 of the strided entry, got {n1}")
        g_p = spec_grads(sc.spectral_corners_plain, x_ft, ws, modes)
        for nm, a, b in zip(("dx", "dw low", "dw high"), g_k, g_p):
            check(f"fused corners {tag}: {nm} through the Function",
                  rel(cre(a), cre(b)), 2e-6)
        if shape in (spec_serving, spec_training):
            corners = torch.cat([x_ft[:, :6, :6], x_ft[:, -6:, :6]], 1)
            w_c = torch.complex(*(torch.cat([v[i] for v in views])
                                  for i in (0, 1)))
            name = "corner_contract" if shape == spec_serving \
                else "corner_b20"
            entry(name, "corner_contract.cu", "ops/pallas_kernels.py:28",
                  [cre(out)], [cre(ref)],
                  lambda: sc.spectral_corners_kernel(x_ft, *views),
                  lambda: sc.spectral_corners_plain(x_ft, ws, modes),
                  spec_work(*shape),
                  lambda: torch.einsum("brmi,rmio->brmo", corners, w_c))
            report[name]["adjoint_ms"] = cuda_ms(
                lambda: sc.spectral_corners_kernel(d_ft, *views,
                                                   adjoint=True))
    b20 = report.pop("corner_b20")
    report["corner_contract"].update(
        {f"{k}_b20": b20[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "max_abs_err",
                                      "adjoint_ms")})
    # the earlier function (stacked corner rows in, stacked rows out) and
    # its bytes, beside the row's
    for B, r in strided.items():
        sfx = "" if B == 1 else "_b20"
        report["corner_contract"].update(
            {f"strided_entry_{k}{sfx}": v for k, v in r.items()})

    log("spectral_conv_nd and FNO2dObserver(12, 12, 32): kernel route "
        "against plain route")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    observer = FNO2dObserver(12, 12, 32, generator=gen)    # 'auto', the card
    observer.requires_grad_(False)
    observer_plain = FNO2dObserver(12, 12, 32, conv_backend="plain")
    observer_plain.load_state_dict(observer.state_dict())
    observer_plain.requires_grad_(False)
    convs = observer.fno2d.fno_blocks.convs
    ws = convs._layer_weights(1)
    for B in (1, 20):
        xb = torch.randn((B, Nx, Nz, 32), generator=gen, device=dev)
        n0 = sc.spectral_corners_kernel.launches
        conv_k = fourier.spectral_conv_nd(xb, ws, (6, 6), fft_norm="forward",
                                          bias=convs.bias[1])
        if sc.spectral_corners_kernel.launches != n0 + 1:
            FAILED.append("spectral_conv_nd('auto') on the card did not "
                          "launch the corner kernel")
        conv_p = fourier.spectral_conv_nd(xb, ws, (6, 6), fft_norm="forward",
                                          bias=convs.bias[1],
                                          backend="plain")
        check(f"spectral_conv_nd B={B}", rel(conv_k, conv_p), 1e-5)
    # output sizes other than the input's (irfftn cuts or pads the spectrum)
    for sizes in ((48, 40), (20, 24), (33, 31)):
        conv_k, conv_p = (fourier.spectral_conv_nd(
            xb, ws, (6, 6), fft_norm="forward", output_sizes=sizes,
            backend=be) for be in ("kernel", "plain"))
        if tuple(conv_k.shape) != (20, *sizes, 32):
            FAILED.append(f"output_sizes {sizes}: shape {conv_k.shape}")
        check(f"spectral_conv_nd output_sizes {sizes}", rel(conv_k, conv_p),
              1e-5)

    # training: the gradients to x and to the stored weights through the
    # conv, kernel route (dx fused entry, dw strided entry) against plain
    def conv_grads(backend):
        xg = xb.clone().requires_grad_()
        leaves = [v.detach().clone().requires_grad_() for w in ws
                  for v in w.values()]
        out = fourier.spectral_conv_nd(
            xg, [{k: v} for w, v in zip(ws, leaves) for k in w], (6, 6),
            fft_norm="forward", backend=backend)
        return torch.autograd.grad((out ** 2).mean(), [xg, *leaves])

    for nm, a, b in zip(("x", "w low", "w high"), conv_grads("kernel"),
                        conv_grads("plain")):
        check(f"spectral_conv_nd B=20 gradient to {nm}", rel(a, b), 1e-5)
    # a factorized weight is not the kernel's: 'auto' contracts it as the
    # caller's `implementation` says, with no launch, and 'kernel' raises
    tucker = [factorized.init_factorized(gen, (32, 32, 6, 6), "tucker")
              for _ in range(2)]
    n0 = sc.spectral_corners_kernel.launches
    conv_t = fourier.spectral_conv_nd(xb, tucker, (6, 6),
                                      implementation="factorized")
    dense_t = [{"tensor": torch.view_as_real(factorized.to_dense(w))
                .movedim(-1, 0)} for w in tucker]
    check("spectral_conv_nd, Tucker weights on the card ('auto', plain "
          "route) against their dense form through the kernel",
          rel(conv_t, fourier.spectral_conv_nd(xb, dense_t, (6, 6),
                                               backend="kernel")), 1e-5)
    if sc.spectral_corners_kernel.launches != n0 + 1:
        FAILED.append("Tucker weights under 'auto' launched the corner "
                      "kernel, or the legacy dense layout did not")
    try:
        fourier.spectral_conv_nd(xb, tucker, (6, 6), backend="kernel")
        FAILED.append("backend='kernel' took Tucker weights")
    except ValueError as e:
        if "backend='kernel' requires" not in str(e):
            raise
    p2_real = p2_p.reshape(1, Nx, Nz)         # the wall pressure after 50 steps
    check("observer forward on a real p2 plane",
          rel(observer(p2_real), observer_plain(p2_real)), 1e-5)

    def action_grad(model):
        v = (-st_p.V[Ny - dp]).reshape(Nx, Nz).clone().requires_grad_()
        loss = torch.linalg.vector_norm(model(v[None, :, :, None])) \
            + 0.1 * torch.linalg.vector_norm(v)
        return torch.autograd.grad(loss, v)[0]

    n0 = sc.spectral_corners_kernel.launches
    g_k = action_grad(observer)
    if sc.spectral_corners_kernel.launches != n0 + 8:
        FAILED.append("gradient through the frozen observer: expected 4 "
                      "forward + 4 dx launches, got "
                      f"{sc.spectral_corners_kernel.launches - n0}")
    check("observer gradient to its input", rel(g_k, action_grad(
        observer_plain)), 1e-5)

    # 4. the main path ------------------------------------------------------
    log("main path: NSControlEnv(32, 130, 32) + gt, run_closed_loop 2000")
    rk.FULLSTEP = True
    kernels = {"rk3_fullstep": rk.env_step_full_kb_kernel,
               "poisson": pc.poisson_solve_kernel,
               "boundary_fwd": rk.boundary_fwd_kernel,
               "boundary_solve": rk.boundary_solve_kernel}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    env = NSControlEnv(Nx, Ny, Nz, detect_plane=dp, noise_scale=0.05, seed=0,
                       device=dev)
    policy = make_policy("gt", env.grid, detect_plane=dp)
    n = 2000
    runs, series = [], None
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_closed_loop(env, policy, n_steps=n, log_interval=n,
                              detect_plane=dp, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            series = res["series"]
            log(f"  warm-up run: {n / dt:.2f} steps/s")
        else:
            runs.append(n / dt)
    launches = {k: fn.launches for k, fn in kernels.items()}
    shear = series["drag_reduction/1_shear_stress"]
    div = res["series"]["drag_reduction/4_1_-|divergence|"]
    log(f"  steps/s: runs {[round(r, 2) for r in runs]} median "
        f"{sorted(runs)[1]:.2f}  ({smi})")
    log(f"  shear stress: first {shear[0]:.6e} last {shear[-1]:.6e}; "
        f"last run's max |div| {np.abs(div).max():.3e} (guard 10)")
    log(f"  launches: {launches}")
    for k, v in res["series"].items():
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite {k}")
    for name in ("U", "V", "W"):
        if not np.isfinite(getattr(env, name)).all():
            raise AssertionError(f"non-finite {name}")
    if launches["rk3_fullstep"] != 4 * n:
        raise AssertionError(f"kernel D launched {launches['rk3_fullstep']} "
                             f"times for {4 * n} steps")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} not launched on the main path")

    # 5. the data-collection path -------------------------------------------
    B, T = 8, 500
    log(f"data collection: batched_rollout of {B} envs, {T} gt steps")
    staged = {"rk3_substage": rk.substage_kernel,
              "rk3_solve_correct": rk.solve_correct_kernel,
              "boundary_batched": rk.boundary_kernel}
    every = {**kernels, **staged}
    expect = {True: {"rk3_fullstep": T},
              False: {"rk3_substage": 3 * T, "rk3_solve_correct": 3 * T,
                      "boundary_batched": T}}
    for fullstep in (True, False):
        rk.FULLSTEP = fullstep
        rates = []
        for r in range(4):
            gen = torch.Generator(device=dev)
            gen.manual_seed(r)
            states = cf.init_batched_states(grid, B, gen)
            torch.cuda.synchronize()
            for fn in every.values():
                fn.launches = 0
            t0 = time.perf_counter()
            states, outs = cf.batched_rollout(grid, states, T,
                                              detect_plane=dp, policy="gt")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in every.items()}
            if r:
                rates.append(B * T / dt)
            want = {k: expect[fullstep].get(k, 0) for k in every}
            if counts != want:
                raise AssertionError(f"FULLSTEP={fullstep}: launches "
                                     f"{counts}, expected {want}")
            shapes = [tuple(o.shape) for o in outs]
            if shapes != [(B, T, Nx, Nz), (B, T, Nx, Nz), (B, T)]:
                raise AssertionError(f"batched_rollout shapes {shapes}")
            for a in (*outs, states.U, states.V, states.W):
                if not torch.isfinite(a).all():
                    raise AssertionError("non-finite batched_rollout output")
        log(f"  {'kernel D' if fullstep else 'staged A+B+C'}: env-steps/s "
            f"runs {[round(x, 2) for x in rates]} median "
            f"{sorted(rates)[1]:.2f}  ({smi})")
        if not fullstep:
            staged_launches = {k: counts[k] for k in staged}
    rk.FULLSTEP = True
    log(f"  staged launches (last run): {staged_launches}")

    n_data = 100
    log(f"generate_channel_dataset, {n_data} steps, read back by PDEDataset")
    env = NSControlEnv(Nx, Ny, Nz, detect_plane=dp, noise_scale=0.05, seed=0,
                       device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        generate_channel_dataset(tmp, n_data, env=env, detect_plane=dp)
        files = os.listdir(tmp)
        meta = np.load(os.path.join(tmp, "metadata.npy"),
                       allow_pickle=True).item()
        p0 = np.load(os.path.join(tmp, f"P_planes_{n_data - 1:06d}.npy"))
        dataset = PDEDataset.from_folder(tmp, range(n_data), x_range=Nx,
                                         y_range=Nz)
    if len(files) != 2 * n_data + 1 \
            or set(meta) != {"P_planes", "V_planes", "re"}:
        raise AssertionError(f"dataset: {len(files)} files, keys {set(meta)}")
    if p0.shape != (Nx, Nz) or not np.isfinite(p0).all():
        raise AssertionError("dataset: bad P plane")
    planes = dataset.arrays()
    for a, norm in zip(planes, (dataset.p_norm, dataset.v_norm)):
        if tuple(a.shape) != (n_data, Nx, Nz, 1) or not a.is_cuda \
                or not torch.isfinite(a).all() or float(norm.std.min()) <= 0:
            raise AssertionError("dataset: bad normalized planes")
    log(f"  {len(files)} files, metadata keys {sorted(meta)}; std of p "
        f"{float(dataset.p_norm.std.mean()):.3e}, of v "
        f"{float(dataset.v_norm.std.mean()):.3e}")

    # 6. the observer-policy path -------------------------------------------
    log("observer-policy path: FNO2dObserver(12, 12, 32) serving")
    shaping = dict(model=observer, detect_plane=dp, p_norm=dataset.p_norm,
                   v_norm=dataset.v_norm)

    def fresh_env():
        return NSControlEnv(Nx, Ny, Nz, detect_plane=dp, noise_scale=0.05,
                            seed=0, device=dev)

    # the two routes through the same 20 steps from the same state
    short = []
    for model in (observer, observer_plain):
        e = fresh_env()
        pol = make_policy("fno", e.grid, **{**shaping, "model": model},
                          action_scale=0.3, action_clip=0.01)
        short.append((run_closed_loop(e, pol, n_steps=20, log_interval=20,
                                      detect_plane=dp, verbose=False,
                                      collect_planes=True), e))
    check("20 fno steps, kernel route against plain route: opV2",
          rel(torch.as_tensor(short[0][0]["opV2"]),
              torch.as_tensor(short[1][0]["opV2"])), 1e-4)
    check("20 fno steps, kernel route against plain route: U",
          rel(short[0][1].state.U, short[1][1].state.U), 1e-5)

    policy_runs = {}
    for name, n_pol, per_step, kw in (
            ("fno", 2000, 4, dict(action_scale=0.3, action_clip=0.01)),
            ("optimal-observer", 200, 80, dict(opt_steps=10))):
        env = fresh_env()
        policy = make_policy(name, env.grid, **shaping, **kw)
        rates = []
        for i in range(4):
            torch.cuda.synchronize()
            for fn in (*every.values(), sc.spectral_corners_kernel,
                       sc.corner_contract_kernel):
                fn.launches = 0
            t0 = time.perf_counter()
            res = run_closed_loop(env, policy, n_steps=n_pol,
                                  log_interval=n_pol, detect_plane=dp,
                                  verbose=False, collect_planes=(i == 0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i:
                rates.append(n_pol / dt)
            else:
                actions = res["opV2"]      # the warm-up run's planes
            got = (sc.spectral_corners_kernel.launches,
                   rk.env_step_full_kb_kernel.launches,
                   sc.corner_contract_kernel.launches)
            if got != (per_step * n_pol, n_pol, 0):
                raise AssertionError(
                    f"{name}: (fused corner entry, kernel D, strided corner "
                    f"entry) launches {got} over {n_pol} steps, expected "
                    f"{(per_step * n_pol, n_pol, 0)}")
            for k, v in res["series"].items():
                if not np.isfinite(v).all():
                    raise AssertionError(f"{name}: non-finite {k}")
        shear = res["series"]["drag_reduction/1_shear_stress"]
        div = res["series"]["drag_reduction/4_1_-|divergence|"]
        flux = np.abs(actions.mean(axis=(1, 2))).max()
        log(f"  {name}: steps/s runs {[round(r, 2) for r in rates]} median "
            f"{sorted(rates)[1]:.2f}  ({smi}); corner launches per run "
            f"{got[0]} ({per_step} per step); shear last {shear[-1]:.6e}, "
            f"max |div| {np.abs(div).max():.3e} (guard 10), max |opV2| "
            f"{np.abs(actions).max():.3e}, max |plane mean| {flux:.1e}")
        if flux > 1e-6:
            raise AssertionError(f"{name}: actuation has a net flux {flux}")
        policy_runs[name] = got[0]

    if FAILED:
        raise AssertionError("failed checks: " + "; ".join(FAILED))
    for k, v in {**launches, **staged_launches,
                 "corner_contract": policy_runs["fno"]}.items():
        report[k]["launches"] = v
    report["corner_contract"]["launches_optimal_observer"] = \
        policy_runs["optimal-observer"]
    print(json.dumps({"kernels": [report[k] for k in
                                  (*every, "corner_contract")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
