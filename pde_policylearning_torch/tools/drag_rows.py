"""The `unmanipulated` and `gt` drag rows of the port, by the protocol of
scripts/drag_study.py: the packaged Re_tau ~ 180 snapshot, detect plane 25,
test plane 124, seed 0, 2000-step chunks, the divergence guard off, and the
tail-mean wall shear over the last half of the run.  The rows run on the
staged RK3 kernels, as that script pins them (PDE_RK3_FULLSTEP=0), or on
kernel D with --fullstep.  With --fno CHECKPOINT an `fno` row follows, as
that script serves it: `FNO2dObserver(12, 12, 32)` from a checkpoint of
`run_pde_observers` (`configs/base_fno.yaml`), the normalizers of the
first 100 planes of --data, action_scale 0.3, action_clip 0.01.

    python -m pde_policylearning_torch.tools.drag_rows [--steps 50000] \\
        [--fullstep] [--fno CKPT --data DIR] [--out DIR]

Prints one JSON object: per row the tail mean, first and last shear,
steps/s and the launch counts of kernel A and kernel D; each row's drag
change against `unmanipulated`; the card's name and power limit.  With
--out it also writes drag_rows.json and the shear series
(drag_rows_shear.npz) there.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from ..control import make_policy, run_closed_loop
from ..data import PDEDataset
from ..envs import NSControlEnv
from ..envs import rk3_cuda as rk
from ..models import FNO2dObserver
from ..training import load_checkpoint
from . import card_name

SHEAR = "drag_reduction/1_shear_stress"


def fno_policy(env, checkpoint: str, data: str, device):
    """The `fno` row's policy: the trained observer and the normalizers of
    the first 100 planes of `data` (scripts/drag_study.py:52-83)."""
    total = len([f for f in os.listdir(data) if f.startswith("P_plane")])
    ds = PDEDataset.from_folder(data, np.arange(min(100, total)),
                                device=device)
    model = FNO2dObserver(12, 12, 32, device=device)
    load_checkpoint(checkpoint, model)
    model.requires_grad_(False)
    return make_policy("fno", env.grid, detect_plane=25, model=model,
                       p_norm=ds.p_norm, v_norm=ds.v_norm, model_timestep=2,
                       action_scale=0.3, action_clip=0.01)


def drag_rows(n_steps: int, fullstep: bool = False, device="cuda",
              grid=(32, 130, 32), fno: Optional[str] = None,
              data: Optional[str] = None):
    """Run the rows; returns (summary dict, {row: shear series})."""
    saved, rk.FULLSTEP = rk.FULLSTEP, fullstep
    res, series = {"card": card_name(), "steps": n_steps,
                   "fullstep": fullstep}, {}
    rows = ("unmanipulated", "gt") + (("fno",) if fno else ())
    try:
        for name in rows:
            env = NSControlEnv(*grid, detect_plane=25, test_plane=124,
                               seed=0, device=device)
            if name == "fno":
                policy = fno_policy(env, fno, data, device)
            else:
                policy = make_policy(name, env.grid, detect_plane=25,
                                     rand_scale=1.0)
            n0 = (rk.substage_kernel.launches,
                  rk.env_step_full_kb_kernel.launches)
            t0 = time.perf_counter()
            # the host reads each chunk's scoreboard, so the clock stops
            # after the card has finished
            out = run_closed_loop(env, policy, n_steps=n_steps,
                                  log_interval=2000, detect_plane=25,
                                  div_guard=1e9, verbose=False)
            dt = time.perf_counter() - t0
            shear = np.asarray(out["series"][SHEAR])
            series[name] = shear
            res[name] = dict(
                tail=float(np.mean(shear[len(shear) // 2:])),
                first=float(shear[0]), last=float(shear[-1]),
                finite=bool(np.isfinite(shear).all()),
                steps_per_s=n_steps / dt, seconds=dt,
                substage_launches=rk.substage_kernel.launches - n0[0],
                kernel_d_launches=(rk.env_step_full_kb_kernel.launches
                                   - n0[1]))
    finally:
        rk.FULLSTEP = saved
    res["drag_change"] = res["gt"]["tail"] / res["unmanipulated"]["tail"] - 1
    for name in rows[1:]:
        res[name]["drag_change"] = (res[name]["tail"]
                                    / res["unmanipulated"]["tail"] - 1)
    return res, series


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--fullstep", action="store_true",
                    help="kernel D instead of the staged kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3, default=(32, 130, 32),
                    metavar=("NX", "NY", "NZ"),
                    help="other than 32 130 32 starts from the laminar "
                         "profile (for a quick check)")
    ap.add_argument("--fno", default=None, metavar="CKPT",
                    help="add the `fno` row with this trained observer")
    ap.add_argument("--data", default="data/planes_channel180_minchan",
                    help="the planes whose first 100 set the normalizers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res, series = drag_rows(args.steps, args.fullstep, args.device,
                            tuple(args.grid), args.fno, args.data)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "drag_rows.json"), "w") as f:
            json.dump(res, f, indent=1)
        np.savez(os.path.join(args.out, "drag_rows_shear.npz"), **series)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
