"""Where the time of one segment-scan call (K3) and one backward sweep (K4)
goes on the card, by kernel name, or of one K5 call in a mode; and the
scan's seeded inputs, which chip_smoke.py's k3, k4 and k5 phases also use.

    python -m tggcn_torch.profile_scan [--reps N] [--hidden H] [--batch B]
                                       [--mode {v1,v4,ext}] [--dtype {float32,bfloat16}]

Builds the kernels, then runs K3 (``segment_scan_dot``, keeping what the
backward reads) and K4 (``segment_scan_dot_bwd``), or with ``--mode`` K5
in that mode (``segment_scan_v1``, ``_v4``, ``_ext``: random attention
weights, or the inverse-distance weights of seeded distances), at the MPHOI
shape (T=167, B=8, 2 humans, 4 objects, h=512; ``--hidden`` and
``--batch`` change h and B, to see how a phase's time scales with the
weights and the rows) with IO in ``--dtype``, one warm-up call each, then
``--reps`` calls of each under ``torch.profiler``. Prints one JSON object:
the card (name and power limit from nvidia-smi) and, per kernel, the device
milliseconds per call by kernel name and the launches per call. Needs a
CUDA device.
"""

import argparse
import json
import math
import re
import subprocess
from collections import defaultdict

import numpy as np
import torch

from tggcn_torch.models import stage1
from tggcn_torch.ops import _build
from tggcn_torch.ops import segment_scan as ops


def scan_inputs(dev, gen, t, b, nh, no, h):
    """K3's inputs at (T, B, humans, objects, h), uniform from gen: states
    and gate inputs in (-1, 1), weights within h^-1/2, random commit
    decisions, and a random object mask, with (B > 1) one batch row fully
    masked and one not masked at all."""
    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).contiguous()
    s = h ** -0.5
    obj_mask = (torch.rand((b, no), generator=gen, device=dev) > 0.3).float()
    if b > 1:
        obj_mask[0] = 0.0              # a batch row with every object masked
        obj_mask[1] = 1.0
    commits = lambda e: (torch.rand((t, b, e), generator=gen, device=dev) > 0.5).float()
    return dict(
        gi_h=u(2, t, b, nh, 3 * h, bound=1.0), gi_o=u(2, t, b, no, 3 * h, bound=1.0),
        u_h=commits(nh), u_o=commits(no),
        w_from=u(4, h, h, bound=s), b_from=u(4, h, bound=s),
        w_msg_h=u(2, 2 * h, 3 * h, bound=s), w_msg_o=u(2, 2 * h, 3 * h, bound=s),
        w_hh_h=u(2, h, 3 * h, bound=s), w_hh_o=u(2, h, 3 * h, bound=s),
        b_hh_h=u(2, 3 * h, bound=s), b_hh_o=u(2, 3 * h, bound=s),
        obj_mask=obj_mask.contiguous(),
        h0_h=u(2, b, nh, h, bound=1.0), h0_o=u(2, b, no, h, bound=1.0))


def bwd_inputs(fwd, gen, scale):
    """K4's inputs for K3's inputs fwd: what the plain forward keeps, the
    previous states and standard-normal upstream gradients from gen, in
    the IO dtype of fwd."""
    out_h, out_o, _, *kept = ops.segment_scan_dot_plain(**fwd, scale=scale)
    kept = dict(zip(ops.KEPT, kept))
    dev = out_h.device
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(out_h.dtype)
    return dict(u_h=fwd["u_h"], u_o=fwd["u_o"], hprev_h=ops.previous_states(out_h, fwd["h0_h"]),
                hprev_o=ops.previous_states(out_o, fwd["h0_o"]),
                **{k: kept[k] for k in ("m_h", "m_o", "gates_h", "gates_o", "atts")},
                g_h=randn(*out_h.shape), g_o=randn(*out_o.shape),
                g_att=randn(*out_h.shape[:-1], out_o.shape[-2]),
                **{k: fwd[k] for k in ("w_from", "w_msg_h", "w_msg_o", "w_hh_h", "w_hh_o")})


def mode_inputs(mode, args, gen):
    """K5's extra inputs in `mode` for the scan inputs args (float32, on
    their device): random w_att and b_att within h^-1/2 (v1, v4), or the
    inverse-distance weights of seeded distances with exact zeros (ext)."""
    from tggcn_torch.models.tggcn import external_att_weights

    _, t, b, nh, g3 = args["gi_h"].shape
    h, no, dev = g3 // 3, args["gi_o"].shape[3], args["gi_h"].device
    if mode == "ext":
        dists = stage1.make_distances(np.random.default_rng(6), b, t, nh, no)
        return dict(att_ext=external_att_weights(
            False, [torch.as_tensor(d, device=dev) for d in dists.values()], args["obj_mask"],
            t, nh))
    shape_w = (4, 2 * h) if mode == "v1" else (4, h, h)
    u = lambda *sh: ((torch.rand(sh, generator=gen, device=dev) * 2 - 1) * h ** -0.5)
    return dict(w_att=u(*shape_w).contiguous(), b_att=u(4).contiguous())


def kernel_name(name):
    """The kernel's own name in a demangled signature such as 'void
    (anonymous namespace)::proj_kernel<0>(float const*, ...)'."""
    found = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return found.group(1) if found else name[:60]


# The card waits this many clock cycles (about 10 ms) at the start of a
# profiler window: the profiler can miss the kernels that run in the first
# stretch of its window (on the H100, the first three of a K4 call, or
# every kernel of a short one).
WINDOW_SPIN_CYCLES = 20_000_000
SPIN_KERNEL = "spin_kernel"             # torch.cuda._sleep's


def device_ms_by_kernel(fn, reps):
    """{kernel name: {"ms": device ms per call, "launches": per call}} of
    reps calls of fn under torch.profiler, after one warm-up call and, in
    the window, a wait on the card (WINDOW_SPIN_CYCLES, not counted);
    largest first."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda._sleep(WINDOW_SPIN_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms, launches = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_name(e.name)
            if name == SPIN_KERNEL:
                continue
            ms[name] += (e.time_range.end - e.time_range.start) / 1e3 / reps
            launches[name] += 1
    return {k: {"ms": ms[k], "launches": launches[k] / reps}
            for k in sorted(ms, key=lambda k: -ms[k])}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--hidden", type=int, default=stage1.MODEL_KWARGS["hidden_size"],
                        help="h (the weights grow as h^2)")
    parser.add_argument("--batch", type=int, default=stage1.SHAPE["b"])
    parser.add_argument("--mode", choices=ops.MODES, default=None,
                        help="time K5 in this mode instead of K3 and K4")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                        help="the kernels' IO dtype")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scan: no CUDA device")
    _build.build()
    dev = torch.device("cuda", 0)
    t, nh, no = (stage1.SHAPE[k] for k in ("t", "humans", "objects"))
    b, h = args.batch, args.hidden
    gen = torch.Generator(device=dev).manual_seed(2)
    dtype = getattr(torch, args.dtype)
    k3 = scan_inputs(dev, gen, t, b, nh, no, h)
    scale = 1.0 / math.sqrt(h)
    if args.mode:
        extra = {k: v.to(dtype) for k, v in mode_inputs(args.mode, k3, gen).items()}
        k5 = {k: v.to(dtype) for k, v in k3.items()}
        wrapper = getattr(ops, f"segment_scan_{args.mode}")
        runs = {f"k5_{args.mode}": lambda: wrapper(**k5, **extra)}
    else:
        k3 = {k: v.to(dtype) for k, v in k3.items()}
        k4 = bwd_inputs(k3, gen, scale)
        runs = {"k3": lambda: ops.segment_scan_dot(**k3, scale=scale),
                "k4": lambda: ops.segment_scan_dot_bwd(**k4, scale=scale)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    print(json.dumps({
        "card": smi, "reps": args.reps, "dtype": args.dtype,
        "shape": dict(t=t, b=b, humans=nh, objects=no, h=h),
        **{name: device_ms_by_kernel(run, args.reps) for name, run in runs.items()}}))


if __name__ == "__main__":
    main()
