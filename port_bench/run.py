"""The benchmark of pde_policylearning_torch on one NVIDIA H100.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration (port_bench/configs/<config>.json) and its traffic; its
parameters and limits are port_bench/cells/<cell>.json, whose `driver`
names port_bench/drivers/<driver>.py.  Each per-layer metric is read by
port_bench/metrics/<metric>.py.  A run sets up (inputs and weights from the
seed, every shape warmed up), measures for --seconds, with --trace 1 traces
one steady slice after the window, then checks the window's answers
against the plain reference and prints one JSON line last.  It refuses to
run without a card and never falls back to the CPU.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pde_policylearning_tpu")


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernels build into build/kernels/ beside it)."""
    base = os.path.join(harness.BENCH, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _metric_reader(name: str):
    path = harness.reader_path(name)
    module = os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _cell_metrics(bench: dict, name: str, kind: str) -> list:
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def prepare(bench: dict, name: str, seed: int, device: str = "cuda",
            cell_overrides: dict | None = None,
            config_overrides: dict | None = None):
    """(the cell's BENCHMARK.json entry, its driver module, the context the
    driver takes: its parameters, its configuration, the seed, the
    device).  `device` and the overrides serve the CPU tests alone."""
    import torch
    w = harness.workload(bench, name)
    cell, config = harness.cell_files(name, w["config"])
    cell.update(cell_overrides or {})
    config.update(config_overrides or {})
    driver = importlib.import_module(f"port_bench.drivers.{cell['driver']}")
    ctx = SimpleNamespace(cell=cell, config=config, seed=seed,
                          device=torch.device(device), name=name)
    return w, driver, ctx


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", cell_overrides: dict | None = None,
            config_overrides: dict | None = None,
            t_start: float | None = None) -> dict:
    """One run of cell `name`; returns the result object (without printing
    it)."""
    import torch
    w, driver, ctx = prepare(bench, name, seed, device, cell_overrides,
                             config_overrides)
    cell = ctx.cell
    S = driver.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - (t_start or T_START)
    win = driver.window(S, ctx, seconds)
    tr = driver.trace(S, ctx) if trace else None
    peak = harness.memory_peak()
    driver.release(S)
    numbers = driver.check(S, ctx, win["samples"])
    ok, shown = harness.checked(numbers, cell["limits"])

    metrics = {}
    if trace:
        run = dict(trace=tr, window=win, **driver.layer_inputs(ctx))
        for m in _cell_metrics(bench, name, "per_layer"):
            v = _metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(win["e2e"], setup_s=setup_s)
        for m in _cell_metrics(bench, name, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": int(w["chips"]), "memory_peak_bytes": peak}
    out = {"correct": ok and not win.get("failed", 0),
           "attempted": win["attempted"], "failed": win.get("failed", 0),
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["check"] = shown
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    bench = harness.benchmark()
    chips = int(harness.workload(bench, args.workload)["chips"])
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found} (no CPU "
              "fallback)", file=sys.stderr)
        return 3
    import subprocess
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    print(f"card {torch.cuda.get_device_name(0)}; power limit {limit}; "
          f"torch {torch.__version__}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    out = execute(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"refused: the process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for k, (v, lim) in out["check"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
