"""Run a function on N ranks of a fresh process group, one process each.

`run_ranks(fn, world_size, device, args, timeout)` spawns world_size
processes (`torch.multiprocessing.start_processes`, the spawn method),
each of which joins a process group through a `file://` rendezvous in a
temporary directory (no port to collide with another group on the same
host), calls `fn(rank, world_size, *args)` and sends its return value back
through a file.  A child's exception is raised again in the parent with
the child's traceback; past the deadline every child is killed and the
parent raises TimeoutError.  Children run with OMP_NUM_THREADS=1.

`fn` is pickled by its import path, so it must live in a module that the
child can import (the port, or a module that imports no JAX at its top).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from .mesh import init_distributed


def _child(index, fn, world_size, device, init_file, out_dir, timeout):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    if device != "cpu":
        device = f"cuda:{index}"
    init_distributed(f"file://{init_file}", world_size, index, device=device,
                     timeout=timeout)
    try:
        result = fn(index, world_size, *args)
        dist.barrier()
    except BaseException:
        # the time tells the first failure from the others it causes (a
        # collective whose peer went away)
        with open(os.path.join(out_dir, f"error{index}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{index}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _first_error(out_dir):
    """(rank, traceback) of the earliest failure the children recorded."""
    found = []
    for name in os.listdir(out_dir):
        if name.startswith("error"):
            with open(os.path.join(out_dir, name)) as f:
                when, text = f.read().split("\n", 1)
            found.append((float(when), int(name[5:-4]), text))
    return min(found)[1:] if found else None


def run_ranks(fn, world_size: int, device: str = "cpu", args=(),
              timeout: float = 120.0):
    """[fn(rank, world_size, *args) for each rank], run on world_size
    processes in one process group: gloo for device 'cpu', NCCL with rank
    r on card r for 'cuda'.  Raises the first failing child's exception
    (with its traceback) or, past `timeout` seconds, TimeoutError, and in
    both cases leaves no child running."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards; "
                           f"{torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory() as d:
        # the arguments go through a file: through the spawn pipe, a child
        # reads them only after its imports, and the parent's write of a
        # large pickle waits for it, which starts the children one by one
        with open(os.path.join(d, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            ctx = tmp.start_processes(
                _child, args=(fn, world_size, device,
                              os.path.join(d, "rendezvous"), d, timeout),
                nprocs=world_size, join=False, start_method="spawn")
        finally:
            if saved is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        deadline = time.monotonic() + timeout
        failure = None
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"run_ranks: {world_size} ranks of "
                        f"{getattr(fn, '__qualname__', fn)} did not finish "
                        f"in {timeout:g} s")
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
            failure = e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
        if failure is not None:
            first = _first_error(d)
            if first is None:
                raise failure
            raise RuntimeError(f"run_ranks: rank {first[0]} failed first:\n"
                               f"{first[1]}") from failure
        results = []
        for r in range(world_size):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
