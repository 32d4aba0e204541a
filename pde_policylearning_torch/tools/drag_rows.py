"""The `unmanipulated` and `gt` drag rows of the port, by the protocol of
scripts/drag_study.py: the packaged Re_tau ~ 180 snapshot, detect plane 25,
test plane 124, seed 0, 2000-step chunks, the divergence guard off, and the
tail-mean wall shear over the last half of the run.  The rows run on the
staged RK3 kernels, as that script pins them (PDE_RK3_FULLSTEP=0), or on
kernel D with --fullstep.  With --fno CHECKPOINT an `fno` row follows, as
that script serves it: `FNO2dObserver(12, 12, 32)` from a checkpoint of
`run_pde_observers` (`configs/base_fno.yaml`), the normalizers of the
first 100 planes of --data, action_scale 0.3, action_clip 0.01.  With
--fullfield CHECKPOINT the two flagship rows follow
(scripts/drag_study.py:86-156): the full-width `PINObserverFullField` of
`configs/fullfield_pi.yaml` from a checkpoint of the port's full-field
training, and `optimal-policy-observer` (a zeroed `PolicyModel2D` adapted
online, 9250 steps) and the full-field `optimal-observer` (the statistics
of the top V plane of --fullfield-data's metadata.npy, 31000 steps), the
step counts of the JAX record.  A row shorter than --steps is also scored
over matched windows: its tail mean against `unmanipulated`'s and `gt`'s
means over the same steps.

    python -m pde_policylearning_torch.tools.drag_rows [--steps 50000] \\
        [--fullstep] [--fno CKPT --data DIR] \\
        [--fullfield CKPT --fullfield-data DIR] [--out DIR]

Prints one JSON object: per row the tail mean, first and last shear,
steps/s and the launch counts of kernel A and kernel D; each row's drag
change against `unmanipulated`; the card's name and power limit.  With
--out it also writes drag_rows.json (after every row) and the shear
series (drag_rows_shear.npz) there.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

import torch

from ..control import (make_fullfield_optimal_observer,
                       make_optimal_policy_observer, make_policy,
                       run_closed_loop)
from ..data import PDEDataset
from ..envs import NSControlEnv
from ..envs import rk3_cuda as rk
from ..models import FNO2dObserver, PINObserverFullField, PolicyModel2D
from ..ops.normalization import NormalizerGivenMeanStd
from ..training import load_checkpoint
from . import card_name

SHEAR = "drag_reduction/1_shear_stress"
FLAGSHIP = ("optimal-policy-observer", "optimal-observer")
# the full-width models of configs/fullfield_pi.yaml (run_pde_observers.py
# :104-107 of the reference)
FULL_WIDTH = dict(modes1=(12,) * 4, modes2=(12,) * 4, modes3=(12,) * 4,
                  layers=(64,) * 5, fc_dim=128, in_dim=1)


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


def fullfield_observer(checkpoint: Optional[str], device,
                       generator: Optional[torch.Generator] = None):
    """The full-width `PINObserverFullField` (scripts/drag_study.py:86-117)
    from `checkpoint` (a file of the port's full-field training), or with
    the weights `generator` draws where it is None; frozen."""
    obs = PINObserverFullField(plane_num=3, pad_ratio=(0.0, 0.0625),
                               **FULL_WIDTH, device=device,
                               generator=generator)
    if checkpoint:
        load_checkpoint(checkpoint, obs)
    return obs.requires_grad_(False)


def top_plane_norm(data: str, device):
    """The V field's statistics on its top wall-normal row, (Nx, Nz), from
    `data`'s metadata.npy (scripts/drag_study.py:126-131)."""
    meta = np.load(os.path.join(data, "metadata.npy"),
                   allow_pickle=True).tolist()
    return NormalizerGivenMeanStd(*(
        torch.as_tensor(np.asarray(meta["V_field"][k])[:, -1, :]).to(
            device, torch.float32) for k in ("mean", "std")))


def flagship_policy(name: str, env, observer, bound_v_norm=None,
                    opt_steps: Optional[int] = None):
    """`optimal-policy-observer` (a zeroed full-width `PolicyModel2D`
    adapted online, 3 Adam steps a control step by default) or the
    full-field `optimal-observer` (10 by default, through `bound_v_norm`)
    with `observer` (scripts/drag_study.py:120-156)."""
    kw = {} if opt_steps is None else {"opt_steps": opt_steps}
    if name == "optimal-observer":
        return make_fullfield_optimal_observer(
            env.grid, observer_model=observer, bound_v_norm=bound_v_norm,
            detect_plane=25, **kw)
    device = next(observer.parameters()).device
    policy = PolicyModel2D(**FULL_WIDTH, device=device).zero_init_params()
    return make_optimal_policy_observer(
        env.grid, observer_model=observer, policy_model=policy,
        detect_plane=25, **kw)


def drag_rows(n_steps: int, fullstep: bool = False, device="cuda",
              grid=(32, 130, 32), fno: Optional[str] = None,
              data: Optional[str] = None, fullfield: Optional[str] = None,
              fullfield_data: Optional[str] = None,
              flagship_steps=(9250, 31000), out_dir: Optional[str] = None):
    """Run the rows; returns (summary dict, {row: shear series})."""
    saved, rk.FULLSTEP = rk.FULLSTEP, fullstep
    res, series = {"card": card_name(), "steps": n_steps,
                   "fullstep": fullstep}, {}
    steps = dict.fromkeys(("unmanipulated", "gt", "fno"), n_steps)
    steps.update(zip(FLAGSHIP, flagship_steps))
    if fullfield and max(flagship_steps) > n_steps:
        raise ValueError("the flagship rows are scored over windows of the "
                         f"unmanipulated row's {n_steps} steps")
    rows = ("unmanipulated", "gt") + (("fno",) if fno else ()) \
        + (FLAGSHIP if fullfield else ())
    try:
        for name in rows:
            env = NSControlEnv(*grid, detect_plane=25, test_plane=124,
                               seed=0, device=device)
            if name == "fno":
                policy = fno_policy(env, fno, data, device)
            elif name in FLAGSHIP:
                policy = flagship_policy(
                    name, env, fullfield_observer(fullfield, device),
                    top_plane_norm(fullfield_data, device))
            else:
                policy = make_policy(name, env.grid, detect_plane=25,
                                     rand_scale=1.0)
            n0 = (rk.substage_kernel.launches,
                  rk.env_step_full_kb_kernel.launches)
            t0 = time.perf_counter()
            # the host reads each chunk's scoreboard, so the clock stops
            # after the card has finished
            n = steps[name]
            out = run_closed_loop(env, policy, n_steps=n,
                                  log_interval=2000, detect_plane=25,
                                  div_guard=1e9, verbose=False)
            dt = time.perf_counter() - t0
            shear = np.asarray(out["series"][SHEAR])
            series[name] = shear
            res[name] = dict(
                steps=n, tail=float(np.mean(shear[n // 2:])),
                first=float(shear[0]), last=float(shear[-1]),
                finite=bool(np.isfinite(shear).all()),
                steps_per_s=n / dt, seconds=dt,
                substage_launches=rk.substage_kernel.launches - n0[0],
                kernel_d_launches=(rk.env_step_full_kb_kernel.launches
                                   - n0[1]))
            if name != "unmanipulated":
                res[name]["drag_change"] = (
                    res[name]["tail"] / res["unmanipulated"]["tail"] - 1)
            if n < n_steps:
                # matched windows: the same steps of the longer rows
                window = {k: float(np.mean(series[k][n // 2:n]))
                          for k in ("unmanipulated", "gt")}
                res[name]["matched"] = dict(
                    window=[n // 2, n], **window,
                    drag_change=res[name]["tail"] / window["unmanipulated"]
                    - 1,
                    gt_drag_change=window["gt"] / window["unmanipulated"]
                    - 1)
            if out_dir:
                write(out_dir, res, series)
    finally:
        rk.FULLSTEP = saved
    res["drag_change"] = res["gt"]["drag_change"]
    if out_dir:
        write(out_dir, res, series)
    return res, series


def write(out_dir: str, res: dict, series: dict):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "drag_rows.json"), "w") as f:
        json.dump(res, f, indent=1)
    np.savez(os.path.join(out_dir, "drag_rows_shear.npz"), **series)


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
    ap.add_argument("--fullfield", default=None, metavar="CKPT",
                    help="add the two flagship rows with this trained "
                         "full-field observer")
    ap.add_argument("--fullfield-data",
                    default="data/planes_channel180_fullfield",
                    help="the full-field dataset whose metadata.npy sets "
                         "the full-field optimal-observer's statistics")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res, _ = drag_rows(args.steps, args.fullstep, args.device,
                       tuple(args.grid), args.fno, args.data,
                       args.fullfield, args.fullfield_data,
                       out_dir=args.out)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
