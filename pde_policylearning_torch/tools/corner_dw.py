"""The corner kernel's weight gradient in the observers' training steps.

    python -m pde_policylearning_torch.tools.corner_dw [--alone-only]
        [--out DIR]

0. Where the checkout has the one-launch entry
   (`spectral_corners_dw_kernel`): the entry alone on seeded spectra at
   the FNO's and the RNO's training shapes (B 20, I = O = 32, 6 x 6
   modes; B 32, I = O = 34, 12 x 12), both contiguous and as the backward
   gets them (x_ft channels-first, dout contiguous): device us per launch
   (profiler over ten calls), ms a call (CUDA events, median of 20), its
   distance from the plain version, and bit for bit two calls (or the
   other layout's result).
   `--alone-only` stops here.
1. The training rows: `FNO2dObserver(12, 12, 32)` at B 20 and
   `RNO2dObserver(12, 12, 34)` at B 32 (weights from a seeded generator;
   the training step of `profile_paths.training_steps`: forward, the
   relative L2 loss, backward, Adam), 20 steps a run: ms a step
   unprofiled (median of three runs after a warm-up), device ms a step,
   busy share and device launches a step (`profile_paths.summarize`), and
   for each corner kernel (the fused entry `spectral_corners_kernel`, the
   strided entry `corner_contract_kernel`, the weight-gradient entry
   `corners_dw_kernel`) its launches a step, device us per launch and
   share of device time, from one run under `torch.profiler`.
2. The weight-gradient calls of one RNO training step, captured where the
   Function's backward receives them (the saved `x_ft`: in a checkout
   without the one-launch entry the channels-first spectrum rfftn leaves,
   with it the contiguous copy the forward entry reads; `dout` with the
   strides autograd gives it, channels-first; the strides are printed),
   and each route on exactly those tensors: the strided route as the
   backward ran it before the one-launch entry (per conv and corner one
   `corner_contract_kernel` launch on the permuted real and imaginary
   views, then the stack and transpose), on that `dout` and on a
   contiguous copy; where the checkout has it, the one-launch entry on
   the contiguous copy its backward makes.  Device us
   per launch of each, read by the profiler (a) on one captured call
   repeated ten times (its inputs stay in L2), (b) once over all the
   step's captured calls (each call's inputs as cold as the spread of 28
   convs leaves them) and (c) right after a training step in the same
   profiler window (L2 holds what the step left there).  Also the host us
   per call of each wrapper and of one `einsum` on the two gathered
   corners (enqueue time: the host clock around 200 calls with no
   synchronize inside).

It runs in a checkout without the one-launch entry too (an earlier commit,
the file copied there), where it measures the strided route alone.  Needs
a CUDA card; prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..models import FNO2dObserver, RNO2dObserver
from ..ops import spectral_cuda as sc
from . import card_name
from .profile_paths import profiled, summarize, training_steps

KERNELS = {"fused": "spectral_corners_kernel",
           "strided": "corner_contract_kernel", "dw": "corners_dw_kernel"}


def device_kernels(fn):
    """[(name, launches, device us)] of one profiled call of fn, the ranges
    the host annotated left out (as `profile_paths.measure` does)."""
    from torch.autograd import DeviceType
    agg = {}
    for e in profiled(fn).events():
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            n, t = agg.get(e.name, (0, 0.0))
            agg[e.name] = (n + 1, t + e.self_device_time_total)
    return [(k, n, t) for k, (n, t) in agg.items()]


def per_kernel(kernels, n_steps):
    """Launches a step, device us per launch and share of device time of
    each corner kernel in `kernels`."""
    total = sum(t for _, _, t in kernels)
    out = {}
    for key, name in KERNELS.items():
        hits = [(n, t) for k, n, t in kernels if name in k]
        n, t = sum(h[0] for h in hits), sum(h[1] for h in hits)
        out[key] = dict(launches_per_step=n / n_steps,
                        device_us_per_launch=t / n if n else None,
                        share=t / total)
    return out


def training_row(model, x, y, n_steps=20):
    run = training_steps(model, x, y, n_steps)
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    kernels = device_kernels(run)
    row = summarize(kernels, sorted(walls)[1], x.shape[0] * n_steps, n_steps)
    row["corner_kernels"] = per_kernel(kernels, n_steps)
    return row


def capture_dw_calls(step):
    """(x_ft, dout, m1, m2) of every conv's backward in one call of step,
    as the backward receives them (`dout` with the strides autograd gives
    it)."""
    calls = []
    backward = sc._SpectralCorners.backward

    def spy(ctx, dout):
        x_ft, w_low, _ = ctx.saved_tensors
        calls.append((x_ft.detach(), dout.detach().resolve_conj(),
                      *w_low.shape[1:3]))
        return backward(ctx, dout)
    sc._SpectralCorners.backward = staticmethod(spy)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        sc._SpectralCorners.backward = staticmethod(backward)
    return calls


def strided_route(x_ft, dout, m1, m2):
    """The weight gradient as `_SpectralCorners.backward` took it before
    the one-launch entry: per corner the strided entry on permuted real /
    imaginary views."""
    dws = []
    for rows in (slice(None, m1), slice(-m1, None)):
        xb, db = x_ft[:, rows, :m2], dout[:, rows, :m2]
        dwr, dwi = sc.corner_contract_kernel(
            xb.real.permute(1, 3, 2, 0), xb.imag.permute(1, 3, 2, 0),
            db.real.permute(1, 2, 0, 3), db.imag.permute(1, 2, 0, 3),
            conj_x=True)
        dws.append(torch.stack([dwr, dwi]).transpose(2, 3))
    return dws


def launch_times(run, name):
    """Device us of each launch of the kernel `name` in one profiled call
    of run (after two unprofiled ones), in launch order."""
    from torch.autograd import DeviceType
    for _ in range(2):
        run()
    evs = sorted((e for e in profiled(run).events()
                  if e.device_type == DeviceType.CUDA and name in e.name),
                 key=lambda e: e.time_range.start)
    return [e.self_device_time_total for e in evs]


def mean(ts):
    return sum(ts) / len(ts) if ts else None


def probe(routes, step):
    """Device us per launch of each route's kernel on its calls: (a) one
    call ten times, (b) one pass over all calls, (c) a step, then one pass
    (the pass's launches are the window's last)."""
    res = {}
    for key, (fn, calls) in routes.items():
        name = KERNELS[key.split("_")[0]]

        def one():
            for _ in range(10):
                fn(*calls[-1])

        def every():
            for c in calls:
                fn(*c)

        def after_step():
            step()
            every()
        a, b = launch_times(one, name), launch_times(every, name)
        c = launch_times(after_step, name)[-len(b):] if b else []
        res[key] = dict(alone_one_call=mean(a), alone_all_calls=mean(b),
                        after_step=mean(c), launches_per_call=len(b) /
                        len(calls))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*calls[-1])
        res[key]["host_us_per_call"] = \
            1e6 * (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
    x_ft, dout, m1, m2 = routes["strided_contiguous"][1][-1]
    xc = torch.cat([x_ft[:, :m1, :m2], x_ft[:, -m1:, :m2]], 1).conj()
    dc = torch.cat([dout[:, :m1, :m2], dout[:, -m1:, :m2]], 1)
    t0 = time.perf_counter()
    for _ in range(200):
        torch.einsum("bhwi,bhwo->hwio", xc, dc)
    res["einsum_host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    return res


# (B, H, Wh, I, O, m1, m2) of the weight gradient in the two training
# steps, and the layouts of x_ft and dout: both contiguous, or as the
# backward hands them over (x_ft channels-first as rfftn left it, dout the
# contiguous copy the gradient to x makes)
ALONE_SHAPES = {"fno_B20": (20, 32, 17, 32, 32, 6, 6),
                "rno_B32": (32, 32, 17, 34, 34, 12, 12)}
LAYOUTS = {"": (False, False), "_backward_layout": (True, False)}


def entry_alone():
    """The one-launch entry alone on seeded spectra at each of
    ALONE_SHAPES and LAYOUTS: device us per launch (profiler over ten
    calls), ms a call by CUDA events (median of 20), its largest distance
    from the plain version and whether two calls agree bit for bit (and
    with the contiguous layout's)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    out = {}
    for (key, (B, H, Wh, I, O, m1, m2)), (tag, first) in (
            (a, b) for a in ALONE_SHAPES.items() for b in LAYOUTS.items()):
        x, d = (torch.complex(*(torch.randn((B, H, Wh, C), generator=gen,
                                            device=dev) for _ in range(2)))
                for C in (I, O))
        if tag:
            dense = sc.spectral_corners_dw_kernel(x, d, m1, m2)
        x, d = (a.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                if f else a for a, f in zip((x, d), first))

        def call():
            return sc.spectral_corners_dw_kernel(x, d, m1, m2)

        def ten():
            for _ in range(10):
                call()
        got, again = call(), call()
        ref = sc.spectral_corners_dw_plain(x, d, m1, m2)
        times = []
        for _ in range(23):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            call()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        out[key + tag] = dict(
            device_us=mean(launch_times(ten, KERNELS["dw"])),
            ms=sorted(times[3:])[10],
            max_abs_err=float(max((a - b).abs().max()
                                  for a, b in zip(got, ref))),
            bitwise=all(torch.equal(a, b) for a, b in zip(
                got, dense if tag else again)))
    return out


def corner_dw(n_steps: int = 20, alone_only: bool = False):
    if not torch.cuda.is_available():
        raise RuntimeError("corner_dw needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"card": card_name(),
           "one_launch_entry": hasattr(sc, "spectral_corners_dw_kernel")}
    if res["one_launch_entry"]:
        res["entry_alone"] = entry_alone()
        print("entry_alone", json.dumps(res["entry_alone"]), flush=True)
    if alone_only:
        return res
    models = {"fno_B20": (FNO2dObserver(12, 12, 32, generator=gen),
                          (20, 32, 32, 1), (20, 32, 32, 1)),
              "rno_B32": (RNO2dObserver(12, 12, 34, generator=gen),
                          (32, 2, 32, 32, 1), (32, 32, 32, 1))}
    for key, (model, xs, ys) in models.items():
        x = torch.randn(xs, generator=gen, device=dev)
        y = torch.randn(ys, generator=gen, device=dev)
        res[f"train_step_{key}"] = training_row(model, x, y, n_steps)
        print(key, json.dumps(res[f"train_step_{key}"]), flush=True)
    model, xs, ys = models["rno_B32"]
    x = torch.randn(xs, generator=gen, device=dev)
    y = torch.randn(ys, generator=gen, device=dev)
    step = training_steps(model, x, y, 1)
    calls = capture_dw_calls(step)
    # the strided route on `dout` as autograd hands it over (as the old
    # backward read it) and made contiguous; the one-launch entry on the
    # contiguous copy its backward makes
    dense = [(c[0].contiguous(), c[1].contiguous(), *c[2:]) for c in calls]
    routes = {"strided": (lambda *c: strided_route(*c), calls),
              "strided_contiguous": (lambda *c: strided_route(*c), dense)}
    if res["one_launch_entry"]:
        routes["dw"] = (lambda x_ft, dout, m1, m2:
                        sc.spectral_corners_dw_kernel(x_ft, dout, m1, m2),
                        dense)
    got = [fn(*cs[-1]) for key, (fn, cs) in routes.items()
           if key != "strided_contiguous"]
    res["rno_B32_dw_calls"] = dict(
        convs_a_step=len(calls),
        shapes=sorted({(tuple(c[0].shape), tuple(c[1].shape), c[2], c[3])
                       for c in calls}),
        strides=sorted({(c[0].stride(), c[1].stride()) for c in calls}),
        routes_max_abs_diff=float(max(
            (a - b).abs().max() for a, b in zip(*got)))
        if len(got) == 2 else None)
    res["rno_B32_dw_calls"].update(probe(routes, step))
    print("rno_B32_dw_calls", json.dumps(res["rno_B32_dw_calls"]), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alone-only", action="store_true",
                    help="the one-launch entry alone, no training step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = corner_dw(alone_only=args.alone_only)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "corner_dw.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
