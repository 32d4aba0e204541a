"""The readings that a cell's limits are set from, in one process.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2 [--fault wrong_lr --fault-seeds 3] \
        [--seconds 3] [--warmup-seconds 1] [--out FILE]

For each seed: the cell's set-up, a short window at the cell's own load and
sizes, then the compared numbers of the program against the plain
reference (the lower readings); for the control seeds the numbers of the
control, the reference in float32 with TF32 emulated put in the program's
place (the upper readings); for the fault seeds those of the fault that the
cell's driver plants in the reference put in the program's place.  One
JSON line per seed, also appended to FILE (default
port_bench/out/readings.jsonl).  The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import harness
from .run import _cache_dirs, prepare


def readings(name: str, seed: int, seconds: float, modes=(),
             device: str = "cuda", cell_overrides=None,
             config_overrides=None, bench=None) -> dict:
    """The program's numbers on `seed` and, for each of `modes` (True for
    the control, or a fault's name), those of the reference put in the
    program's place."""
    import torch
    _, driver, ctx = prepare(bench or harness.benchmark(), name, seed,
                             device, cell_overrides, config_overrides)
    t0 = time.time()
    S = driver.setup(ctx)
    win = driver.window(S, ctx, seconds)
    driver.release(S)
    out = {"seed": seed, "program": driver.check(S, ctx, win["samples"])}
    for mode in modes:
        out["control" if mode is True else mode] = driver.check(
            S, ctx, win["samples"], control=mode)
    out["seconds"] = time.time() - t0
    del S, win
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="",
                    help="a fault the driver plants in the reference "
                    "(the loop: wrong_lr)")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--warmup-seconds", type=float, default=None,
                    help="a shorter warm-up than the cell's (the readings "
                    "do not time the window)")
    ap.add_argument("--out", default=os.path.join(harness.BENCH, "out",
                                                  "readings.jsonl"))
    args = ap.parse_args(argv)
    _cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3

    def seeds(text):
        return [int(s) for s in text.split(",") if s]
    ctl, flt = set(seeds(args.control_seeds)), set(seeds(args.fault_seeds))
    over = ({} if args.warmup_seconds is None
            else {"warmup_seconds": args.warmup_seconds})
    for s in seeds(args.seeds):
        modes = ([True] if s in ctl else []) + \
            ([args.fault] if s in flt and args.fault else [])
        line = json.dumps(dict(readings(args.workload, s, args.seconds,
                                        modes, cell_overrides=over),
                               workload=args.workload))
        print(line, flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
