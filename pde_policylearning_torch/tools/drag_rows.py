"""The drag study of the port, by the protocol of scripts/drag_study.py:
the packaged Re_tau ~ 180 snapshot (or --init's), detect plane 25, test
plane 124, seed 0, 2000-step chunks, the divergence guard off, and the
tail-mean wall shear over the last half of the run.  The rows run on the
staged RK3 kernels, as that script pins them (PDE_RK3_FULLSTEP=0), or on
kernel D with --fullstep.  Rows, in the study's order:

- `unmanipulated` and `gt`, always; `rand` with --rand (uniform actuation
  on [0, 0.01), drawn from the loop's seeded generator);
- `fno`, `rno` and `transformer` with --fno / --rno / --transformer CKPT,
  served as scripts/drag_study.py:52-83 serves them: `FNO2dObserver(12,
  12, 32)`, `RNO2dObserver(12, 12, 34, layer_num=1)` or
  `SimpleTransformer(n_hidden=96, n_head=2, attention_type="fourier",
  freq_dim=48, fourier_modes=12)` from a checkpoint of `run_pde_observers`
  (the port's `.pt` or the JAX package's `.msgpack`), frozen, the
  normalizers of --data (its first 100 planes), model_timestep 2,
  action_scale 0.3, action_clip 0.01;
- with --fullfield CKPT the two flagship rows (scripts/drag_study.py
  :86-156): the full-width `PINObserverFullField` of
  `configs/fullfield_pi.yaml` from a checkpoint of the port's full-field
  training, and `optimal-policy-observer` (a zeroed `PolicyModel2D`
  adapted online, 9250 steps) and the full-field `optimal-observer` (the
  statistics of the top V plane of --fullfield-data's metadata.npy, 31000
  steps), the step counts of the JAX record;
- with --ddpg CKPT a `ddpg` row (scripts/drag_study.py:158-169): the
  actor that `main_ddpg --channel` trained and saved, deterministic, max
  action 0.01.

A row shorter than --steps (the flagship rows, a promoted partial) is
also scored over matched windows: its tail mean against
`unmanipulated`'s and `gt`'s means over the same steps.

With --out the study's protocol for long rows (scripts/drag_study.py
:1-18, 172-291) holds there: each row's series is cached as <row>.npz
with its tag and step count, and a cached row is read, not run again;
every chunk banks <row>.partial.npz (over a shorter partial only);
--promote ROW,... turns a row's partial into its final file; --deadline
EPOCH_SECONDS stops a running row at its next chunk and promotes what it
has (rows not yet started then are left out); --only ROW,... runs only
the named rows (cached ones are still read); a row that fails is
recorded as failed and the rest go on (the exit code is then 1).  The
markdown table (table.md, also on stderr) and summary.json are written
as that script writes them, with drag_rows.json and the series
(drag_rows_shear.npz), after every row.

    python -m pde_policylearning_torch.tools.drag_rows [--steps 50000] \\
        [--fullstep] [--init NPZ] [--rand] [--fno CKPT] [--rno CKPT] \\
        [--transformer CKPT] [--data DIR] \\
        [--fullfield CKPT --fullfield-data DIR] [--ddpg CKPT] \\
        [--out DIR [--only ROWS] [--promote ROWS] [--deadline SECONDS]]

Prints one JSON object: per row the tail mean, first and last shear,
steps/s and the launch counts of kernel A, kernel D and the corner
contraction's fused entry; each row's drag
change against `unmanipulated`; the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

import torch

from ..control import (Actor, make_ddpg_policy,
                       make_fullfield_optimal_observer,
                       make_optimal_policy_observer, make_policy,
                       run_closed_loop)
from ..data import PDEDataset
from ..envs import NSControlEnv
from ..envs import rk3_cuda as rk
from ..models import (FNO2dObserver, PINObserverFullField, PolicyModel2D,
                      RNO2dObserver, SimpleTransformer)
from ..ops import spectral_cuda as sc
from ..ops.normalization import NormalizerGivenMeanStd
from ..training import load_checkpoint
from . import card_name

SHEAR = "drag_reduction/1_shear_stress"
FLAGSHIP = ("optimal-policy-observer", "optimal-observer")
OBSERVERS = ("fno", "rno", "transformer")
# the study's rows in its order (scripts/drag_study.py:253-256)
ROWS = ("unmanipulated", "gt", "rand", *OBSERVERS, *FLAGSHIP, "ddpg")
# the full-width models of configs/fullfield_pi.yaml (run_pde_observers.py
# :104-107 of the reference)
FULL_WIDTH = dict(modes1=(12,) * 4, modes2=(12,) * 4, modes3=(12,) * 4,
                  layers=(64,) * 5, fc_dim=128, in_dim=1)
# the study's chunk: one host read, one banked partial
# (scripts/drag_study.py:178)
CHUNK = 2000
# the kernels' launch counters read per row: kernel A (staged), kernel D,
# the corner contraction's fused entry (the observers' spectral convs)
COUNTERS = {"substage_launches": rk.substage_kernel,
            "kernel_d_launches": rk.env_step_full_kb_kernel,
            "corner_launches": sc.spectral_corners_kernel}


def observer(name: str, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None):
    """The observer of the `name` row at the study's widths
    (scripts/drag_study.py:61-76), its weights drawn from `generator`."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    if name == "fno":
        return FNO2dObserver(12, 12, 32, **kw)
    if name == "rno":
        return RNO2dObserver(12, 12, 34, layer_num=1, **kw)
    return SimpleTransformer(n_hidden=96, n_head=2, attention_type="fourier",
                             freq_dim=48, fourier_modes=12, **kw)


def observer_policy(name: str, env, checkpoint: str, data: str, device):
    """The `fno`, `rno` or `transformer` row's policy: the trained observer,
    frozen, and the normalizers of the first 100 planes of `data`
    (scripts/drag_study.py:52-83), in the env's dtype."""
    total = len([f for f in os.listdir(data) if f.startswith("P_plane")])
    ds = PDEDataset.from_folder(data, np.arange(min(100, total)),
                                device=device, dtype=env.dtype)
    model = observer(name, device, env.dtype)
    load_checkpoint(checkpoint, model)
    model.requires_grad_(False)
    return make_policy(name, env.grid, detect_plane=25, model=model,
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


def ddpg_policy(env, checkpoint: str, device):
    """The trained on-device DDPG actor as its row serves it."""
    Nx, Nz = env.grid.Nx, env.grid.Nz
    actor = Actor(Nx * Nz, Nx * Nz, max_action=0.01, device=device)
    load_checkpoint(checkpoint, actor)
    return make_ddpg_policy(actor, Nx, Nz)


class _Deadline(Exception):
    """Raised from a chunk's callback once the deadline has passed: the
    partial banked so far becomes the row's final file."""


def _save(path: str, **arrays):
    """np.savez to `path` through a temporary file, so that a run killed
    while writing leaves the previous file whole."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _files(out_dir: str, name: str):
    return (os.path.join(out_dir, f"{name}.npz"),
            os.path.join(out_dir, f"{name}.partial.npz"))


def promote(out_dir: str, names: Sequence[str]) -> list:
    """Turn each named row's partial into its final file where it has no
    final file yet (scripts/drag_study.py:259-266); returns the rows
    promoted."""
    done = []
    for name in names:
        final, partial = _files(out_dir, name)
        if os.path.exists(partial) and not os.path.exists(final):
            os.replace(partial, final)
            done.append(name)
    return done


def _read_row(path: str):
    """(shear, the row's record) of a cached or banked row."""
    d = np.load(path)
    row = json.loads(str(d["row"]))
    row["tag"] = str(d["tag"])
    return d["shear"], row


def _score(res: dict, series: dict, name: str, n_steps: int):
    """The tail mean of `name`'s series and its drag change against
    `unmanipulated`; a row shorter than n_steps also over the same steps
    of `unmanipulated` and `gt` (matched windows)."""
    shear = series[name]
    n = len(shear)
    row = res[name]
    row.update(steps=n, tail=float(np.mean(shear[n // 2:])),
               first=float(shear[0]), last=float(shear[-1]),
               finite=bool(np.isfinite(shear).all()))
    base = res.get("unmanipulated", {}).get("tail")
    if name != "unmanipulated" and base:
        row["drag_change"] = row["tail"] / base - 1
    if n < n_steps and all(len(series.get(k, ())) >= n
                           for k in ("unmanipulated", "gt")):
        window = {k: float(np.mean(series[k][n // 2:n]))
                  for k in ("unmanipulated", "gt")}
        row["matched"] = dict(
            window=[n // 2, n], **window,
            drag_change=row["tail"] / window["unmanipulated"] - 1,
            gt_drag_change=window["gt"] / window["unmanipulated"] - 1)


def table(res: dict, names: Sequence[str], n_steps: int) -> str:
    """The study's markdown table (scripts/drag_study.py:276-287)."""
    base = res.get("unmanipulated", {}).get("tail")
    lines = ["| policy | tail-mean shear | vs unmanipulated | steps |",
             "|---|---|---|---|"]
    for n in names:
        row = res[n]
        if "failed" in row:
            lines.append(f"| {n} | diverged/failed | — | — |")
        elif base:
            s = row["steps"]
            note = f"{s}" if s >= n_steps else f"{s} (budget-bounded)"
            lines.append(f"| {n} | {row['tail']:.3e} | "
                         f"{100 * (row['tail'] - base) / base:+.1f}% "
                         f"| {note} |")
    return "\n".join(lines)


def drag_rows(n_steps: int, fullstep: bool = False, device="cuda",
              grid=(32, 130, 32), fno: Optional[str] = None,
              data: Optional[str] = None, fullfield: Optional[str] = None,
              fullfield_data: Optional[str] = None,
              flagship_steps=(9250, 31000), out_dir: Optional[str] = None,
              ddpg: Optional[str] = None, rand: bool = False,
              rno: Optional[str] = None, transformer: Optional[str] = None,
              init: Optional[str] = None,
              only: Optional[Sequence[str]] = None,
              promote_rows: Sequence[str] = (),
              deadline: Optional[float] = None, dtype=torch.float32):
    """Run the rows; returns (summary dict, {row: shear series}).  The
    cache, the partials and the files of the study are kept under
    `out_dir` where it is given; `deadline` is an epoch time."""
    if (deadline or promote_rows) and not out_dir:
        raise ValueError("a deadline and --promote act on the partials "
                         "under out_dir")
    if fullfield and max(flagship_steps) > n_steps:
        raise ValueError("the flagship rows are scored over windows of the "
                         f"unmanipulated row's {n_steps} steps")
    checkpoints = dict(fno=fno, rno=rno, transformer=transformer, ddpg=ddpg,
                       **dict.fromkeys(FLAGSHIP, fullfield))
    wanted = dict(unmanipulated=True, gt=True, rand=rand, **checkpoints)
    steps = dict.fromkeys(ROWS, n_steps)
    steps.update(zip(FLAGSHIP, flagship_steps))
    res = {"card": card_name(), "steps": n_steps, "fullstep": fullstep}
    series, names = {}, []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        res["promoted"] = promote(out_dir, promote_rows)
    saved, rk.FULLSTEP = rk.FULLSTEP, fullstep
    try:
        for name in (r for r in ROWS if wanted[r]):
            final, partial = _files(out_dir, name) if out_dir else (None,) * 2
            cached = final is not None and os.path.exists(final)
            if not cached and only and name not in only:
                continue
            if not cached and deadline and time.time() > deadline:
                res.setdefault("not_started", []).append(name)
                continue
            names.append(name)
            try:
                if cached:
                    series[name], res[name] = _read_row(final)
                    res[name]["cached"] = True
                else:
                    series[name], res[name] = _run_row(
                        name, steps[name], grid, device, dtype, init,
                        checkpoints.get(name), data, fullfield_data,
                        final, partial, deadline)
                _score(res, series, name, n_steps)
            except Exception as e:     # recorded; the other rows go on
                print(f"{name}: FAILED - {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                res[name] = {"failed": f"{type(e).__name__}: {e}"}
                series.pop(name, None)
            if out_dir:
                write(out_dir, res, series, names, n_steps)
    finally:
        rk.FULLSTEP = saved
    if "drag_change" in res.get("gt", {}):
        res["drag_change"] = res["gt"]["drag_change"]
    res["table"] = table(res, names, n_steps)
    print(res["table"], file=sys.stderr, flush=True)
    if out_dir:
        write(out_dir, res, series, names, n_steps)
    return res, series


def row_policy(name: str, env, device, checkpoint: Optional[str] = None,
               data: Optional[str] = None,
               fullfield_data: Optional[str] = None):
    """(policy, tag) of the row `name` on `env`."""
    if name in OBSERVERS:
        return (observer_policy(name, env, checkpoint, data, device),
                f"{name}:{os.path.basename(checkpoint)}")
    if name == "ddpg":
        return (ddpg_policy(env, checkpoint, device),
                f"ddpg:{os.path.basename(checkpoint)}")
    if name in FLAGSHIP:
        return (flagship_policy(name, env,
                                fullfield_observer(checkpoint, device),
                                top_plane_norm(fullfield_data, device)),
                f"{name}:{os.path.basename(checkpoint)}")
    return make_policy(name, env.grid, detect_plane=25, rand_scale=1.0), name


def _run_row(name, n, grid, device, dtype, init, checkpoint, data,
             fullfield_data, final, partial, deadline):
    """Run one row for `n` steps; returns (shear, the row's record).  With
    the study's files (`final`, `partial`; None without --out) each chunk
    banks the series so far into `partial` over a shorter partial, past
    `deadline` the banked series becomes `final`, and the finished row is
    written to `final`."""
    env = NSControlEnv(*grid, detect_plane=25, test_plane=124, seed=0,
                       init_cond_path=init, dtype=dtype, device=device)
    policy, tag = row_policy(name, env, device, checkpoint, data,
                             fullfield_data)
    n0 = {k: fn.launches for k, fn in COUNTERS.items()}
    best_prev = int(np.load(partial)["steps"]) \
        if partial and os.path.exists(partial) else 0
    parts = []

    def record(done):
        seconds = time.perf_counter() - t0
        return dict({k: fn.launches - n0[k] for k, fn in COUNTERS.items()},
                    steps_per_s=done / seconds, seconds=seconds)

    def on_chunk(done, infos):
        # the host has read this chunk's scoreboard: the card is done
        parts.append(np.asarray(infos[SHEAR]))
        print(f"  [{name} {done}/{n}] shear {parts[-1][-1]:.4e}",
              file=sys.stderr, flush=True)
        if partial and done > best_prev:
            _save(partial, shear=np.concatenate(parts), tag=tag, steps=done,
                  row=json.dumps(record(done)))
        if deadline and time.time() > deadline:
            raise _Deadline(f"{name} reached the deadline at {done} steps")

    t0 = time.perf_counter()
    try:
        out = run_closed_loop(env, policy, n_steps=n, log_interval=CHUNK,
                              detect_plane=25, div_guard=1e9, verbose=False,
                              on_chunk=on_chunk)
    except _Deadline as e:
        print(f"  [{name}] {e}; promoting the partial", file=sys.stderr,
              flush=True)
        os.replace(partial, final)
        shear, row = _read_row(final)
        return shear, dict(row, deadline=True)
    shear = np.asarray(out["series"][SHEAR])
    row = record(n)
    if final:
        _save(final, shear=shear, tag=tag, steps=len(shear),
              row=json.dumps(row))
        if os.path.exists(partial):
            os.remove(partial)
    return shear, dict(row, tag=tag)


def write(out_dir: str, res: dict, series: dict, names: Sequence[str],
          n_steps: int):
    """drag_rows.json, the series, and the study's table.md and
    summary.json (scripts/drag_study.py:276-291) of the rows `names`."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "drag_rows.json"), "w") as f:
        json.dump(res, f, indent=1)
    np.savez(os.path.join(out_dir, "drag_rows_shear.npz"), **series)
    with open(os.path.join(out_dir, "table.md"), "w") as f:
        f.write(table(res, names, n_steps) + "\n")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"tail_mean": {n: res[n].get("tail") for n in names},
                   "steps": {n: res[n]["steps"] for n in names
                             if "steps" in res[n]}}, f, indent=1)


def failed(res: dict) -> list:
    """The rows of a summary that failed."""
    return [k for k, v in res.items() if isinstance(v, dict) and "failed" in v]


def rows_arg(text: str) -> list:
    names = [n for n in text.split(",") if n]
    unknown = set(names) - set(ROWS)
    if unknown:
        raise argparse.ArgumentTypeError(f"no such row: {sorted(unknown)}")
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--fullstep", action="store_true",
                    help="kernel D instead of the staged kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3, default=(32, 130, 32),
                    metavar=("NX", "NY", "NZ"),
                    help="other than 32 130 32 starts from the laminar "
                         "profile unless --init names a state")
    ap.add_argument("--init", default=None, metavar="NPZ",
                    help="start every row from this state (a snapshot of "
                         "tools.spinup; default: the packaged snapshot)")
    ap.add_argument("--rand", action="store_true",
                    help="add the `rand` row")
    for name in OBSERVERS:
        ap.add_argument(f"--{name}", default=None, metavar="CKPT",
                        help=f"add the `{name}` row with this trained "
                             "observer")
    ap.add_argument("--data", default="data/planes_channel180_minchan",
                    help="the planes whose first 100 set the normalizers")
    ap.add_argument("--fullfield", default=None, metavar="CKPT",
                    help="add the two flagship rows with this trained "
                         "full-field observer")
    ap.add_argument("--fullfield-data",
                    default="data/planes_channel180_fullfield",
                    help="the full-field dataset whose metadata.npy sets "
                         "the full-field optimal-observer's statistics")
    ap.add_argument("--ddpg", default=None, metavar="CKPT",
                    help="add the `ddpg` row with this trained actor "
                         "(main_ddpg --channel)")
    ap.add_argument("--out", default=None,
                    help="the study's directory: cached rows, partials, "
                         "table.md, summary.json")
    ap.add_argument("--only", type=rows_arg, default=None, metavar="ROWS",
                    help="run only these rows (comma-separated)")
    ap.add_argument("--promote", type=rows_arg, default=[], metavar="ROWS",
                    help="turn these rows' partials into their final files")
    ap.add_argument("--deadline", type=float, default=None,
                    metavar="EPOCH_SECONDS",
                    help="stop a row at its next chunk after this time and "
                         "promote its partial")
    args = ap.parse_args(argv)
    if (args.promote or args.deadline) and not args.out:
        ap.error("--promote and --deadline need --out")
    res, _ = drag_rows(args.steps, args.fullstep, args.device,
                       tuple(args.grid), args.fno, args.data,
                       args.fullfield, args.fullfield_data,
                       out_dir=args.out, ddpg=args.ddpg, rand=args.rand,
                       rno=args.rno, transformer=args.transformer,
                       init=args.init, only=args.only,
                       promote_rows=args.promote, deadline=args.deadline)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(1 if failed(main()) else 0)
