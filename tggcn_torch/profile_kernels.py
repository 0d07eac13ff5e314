"""Card times of K3 and K4, of K5 in each mode, each in both dtypes, and of
K6 at the MPHOI shape, in the checkout whose ``tggcn_torch`` is on the
import path: for comparing two checkouts on one card, in turns (old, new,
new, old).

    python -m tggcn_torch.profile_kernels [--reps N] [--geo-frames N1,N2,...]
                                          [--kernels {all,scan,modes}]
    cd <other checkout> && PYTHONPATH=. python <this tree>/tggcn_torch/profile_kernels.py

K3 (``segment_scan_dot``, keeping what K4 reads) and K4
(``segment_scan_dot_bwd``) run on chip_smoke.py's k3 and k4 inputs (seeds
2 and 5), K5 (``segment_scan_v1``, ``_v4``, ``_ext``) on chip_smoke.py's k5
inputs (``profile_scan.scan_inputs`` and ``mode_inputs``, seed 6) in
float32 and bfloat16, K6 (``geo_gcn_fused``) on chip_smoke.py's k6 inputs
(N = 1336 frames of V = 26 nodes, seed 7). Each time is the median of
``--reps`` calls timed by CUDA events behind a wait on the card, so that it
is the card's time (chip_smoke.py's cuda_ms with spin), K6 also at the
frame counts of ``--geo-frames``; each K3, K4 and K5 row also gives its
device ms per call by kernel name (``torch.profiler``). Prints
one JSON object: the card's name and power limit (nvidia-smi), the
checkout's path and, per row, ms and split. Needs a CUDA device; uses only
entry points that the port has had since K5 and K6 came.
"""

import argparse
import json
import math
import statistics
import subprocess

import torch

import tggcn_torch
from tggcn_torch.ops import _build
from tggcn_torch.ops import segment_scan as ops
from tggcn_torch.ops.geo_gcn import geo_gcn_fused
from tggcn_torch.profile_scan import bwd_inputs, device_ms_by_kernel, mode_inputs, scan_inputs

SPIN_CYCLES = 20_000_000        # about 10 ms at the H100's clock, as chip_smoke.py


def card_ms(fn, reps):
    """Median ms of fn() on the card, after a warm-up, each call behind a
    wait on the card so that the events time the card's work alone."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k3_k4_rows(dev, reps):
    """K3 and K4 in float32 and bfloat16 on chip_smoke.py's k3 and k4
    inputs (seeds 2 and 5): the call's card ms and its split."""
    t, b, nh, no, h = 167, 8, 2, 4, 512
    scale = 1.0 / math.sqrt(h)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        k3 = {k: v.to(dtype) for k, v in scan_inputs(
            dev, torch.Generator(device=dev).manual_seed(2), t, b, nh, no, h).items()}
        gen = torch.Generator(device=dev).manual_seed(5)
        fwd = {k: v.to(dtype) for k, v in scan_inputs(dev, gen, t, b, nh, no, h).items()}
        k4 = bwd_inputs(fwd, gen, scale)
        for name, fn in ((f"k3{tag}", lambda: ops.segment_scan_dot(**k3, scale=scale)),
                         (f"k4{tag}", lambda: ops.segment_scan_dot_bwd(**k4, scale=scale))):
            rows[name] = dict(ms=card_ms(fn, reps), split=device_ms_by_kernel(fn, 1))
    return rows


def k5_rows(dev, reps):
    t, b, nh, no, h = 167, 8, 2, 4, 512
    rows = {}
    for mode in ops.MODES:
        gen = torch.Generator(device=dev).manual_seed(6)
        args = scan_inputs(dev, gen, t, b, nh, no, h)
        extra = mode_inputs(mode, args, gen)
        wrapper = getattr(ops, f"segment_scan_{mode}")
        for dtype in (torch.float32, torch.bfloat16):
            a = {k: v.to(dtype) for k, v in args.items()}
            e = {k: v.to(dtype) for k, v in extra.items()}
            name = f"k5_{mode}" + ("_bf16" if dtype == torch.bfloat16 else "")
            rows[name] = dict(ms=card_ms(lambda: wrapper(**a, **e), reps),
                              split=device_ms_by_kernel(lambda: wrapper(**a, **e), 1))
    return rows


def k6_row(dev, reps, frames=()):
    """K6's ms at N = 1336, and at each N of frames (how its time grows
    with the frames a block takes)."""
    n, v = 1336, 26
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128)]
    weights = [((torch.rand(sh, generator=gen, device=dev) * 2 - 1) * sh[0] ** -0.5).contiguous()
               for sh in shapes]
    x = torch.randn((n, v, 4), generator=gen, device=dev)
    row = dict(ms=card_ms(lambda: geo_gcn_fused(x, *weights), reps))
    for f in frames:
        xf = x[:f].contiguous()
        row[f"ms_at_{f}"] = card_ms(lambda: geo_gcn_fused(xf, *weights), reps)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=9)
    parser.add_argument("--geo-frames", default="",
                        help="comma-separated N (<= 1336) to time K6 at besides 1336")
    parser.add_argument("--kernels", choices=("all", "scan", "modes"), default="all",
                        help="scan: K3 and K4 only; modes: K5 and K6 only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    _build.build()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    frames = [int(f) for f in args.geo_frames.split(",") if f]
    rows = {}
    if args.kernels in ("all", "scan"):
        rows.update(k3_k4_rows(dev, args.reps))
    if args.kernels in ("all", "modes"):
        rows.update(k5_rows(dev, args.reps), k6=k6_row(dev, args.reps, frames))
    print(json.dumps({"card": smi, "checkout": str(_build.PACKAGE_DIR.parent),
                      "package": tggcn_torch.__file__, "reps": args.reps, **rows}))


if __name__ == "__main__":
    main()
