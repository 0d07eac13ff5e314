"""Time the stage-1 (or stage-2, or CAD-120 stage-1) train step and
request on the card, over more repetitions than chip_smoke.py takes, and
split the train step's device time by kernel.

    python -m tggcn_torch.profile_step [--steps N] [--requests N] [--seed N]
                                       [--dtype {float32,bfloat16}]
                                       [--stage {1,2,cad120}]
                                       [--variant {dist,v1,v4,mp}] [--fused K]

Builds the stage-1 MPHOI model (``tggcn_torch.models.stage1``), or with
``--stage 2`` the stage-2 one (``stage2``: its batch, loss bundle and
Gumbel noise for humans and objects), or with ``--stage cad120`` the
CAD-120 stage-1 one (``cad120``: B=16, 1 human, 5 object slots, the
12-loss bundle, its segment scan the general one, with ``--variant dist``
its two distance tensors and the GeoGCN kernel), or with ``--variant`` the
stage-1 model in one of ``stage1.SERVE_VARIANTS`` (its segment scan through K5, its
gradients from the recompute of ``models/segment_fast.py``; 'dist' with
distance tensors in the batch and the requests), at the full width on one CUDA card,
in the compute dtype ``--dtype`` (float32 by default; ``bench.py`` trains
in bfloat16), with random weights and a seeded batch resident on the card,
as chip_smoke.py's train phases do. Runs 2 warm-up train steps
on the kernel route, then ``--steps`` timed steps (host clock, each ended
by a synchronize), then 3 steps under ``torch.profiler``; then one warm-up
request and ``--requests`` timed requests of the same shape (host->device
copy included). Prints one JSON object: the card (name and power limit from
nvidia-smi), the train step's and the request's wall ms (median and
quartiles), the train step's device-busy ms and idle share, its device ms
by group (K1-K6 by their kernel names, cuBLAS's products, Adam's
multi-tensor kernels, the rest as "other"), its largest kernels and the
largest of "other"; with ``--variant``, also the recompute backward's wall
ms a step (its profiler range) and the device busy ms of the kernels that
start inside that range. Where the model's segment scan is the general
one (``models/segment_general.py``), "general_scan" gives, from the same
profiled steps, the device ms a step of its forward (the kernels launched
inside its profiler range, GENERAL_SCAN_RANGE) and of its backward (those
of the autograd nodes made there), their kernels and ms by group, and
their share of the step's busy ms.

With ``--fused K`` it also times the same step fused, K steps a call
(``tggcn_torch.train.loop.make_fused_train_steps``: one step captured in a
CUDA graph and replayed), on its own copy of the weights with a capturable
Adam, each call drawing fresh Gumbel noise on the card: the first call's
seconds (warm-up, capture, K replays), FUSED_WINDOWS timed windows (ms a
step, host clock, each window ended by a synchronize), and one window of
PROFILED_STEPS steps under torch.profiler (busy ms, idle share of the
profiled wall and of the timed windows' ms a step, kernels and ms by group
a step), and the peak device memory over the capture and the windows,
under "fused" in the JSON object. A step that cannot be captured
raises.

An earlier commit is timed with its own copy of this module, from its
checkout's root. Needs a CUDA device.
"""

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
from tggcn_torch.models import stage1
from tggcn_torch.models.segment_general import GENERAL_SCAN_RANGE
from tggcn_torch.models.registry import select_model
from tggcn_torch.nn.distributions import gumbel_noise
from tggcn_torch.ops import segment_scan
from tggcn_torch.profile_forward import _union_us
from tggcn_torch.train.loop import make_train_step, trainable_parameters
from tggcn_torch.train.losses import select_loss

PROFILED_STEPS = 3
BACKWARD_SCOPE = 1                 # a backward node's torch.profiler scope (RecordScope)
ENGINE_RANGE = "autograd::engine::evaluate_function"
FUSED_WINDOWS = 5
# Kernel-name fragments of the train step's kernels (both designs' names),
# then cuBLAS's products and the optimizer's multi-tensor kernels.
GROUPS = {"gru_step_kernel": "K1", "gru_cluster_kernel": "K1", "gru_bwd": "K2",
          "proj_kernel": "K3", "proj_wg": "K3", "mix_kernel": "K3", "cell_kernel": "K3", "cell_wg": "K3", "segb_": "K4", "du_sum": "K4",
          "geo_gcn": "K6", "gemm": "cuBLAS", "nvjet": "cuBLAS", "xmma": "cuBLAS",
          "multi_tensor_apply": "Adam"}


def group_of(name):
    return next((g for key, g in GROUPS.items() if key in name), "other")


def spread(times):
    q = statistics.quantiles(times, n=4)
    return dict(median=statistics.median(times), q1=q[0], q3=q[2], n=len(times))


def timed(fn, reps):
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return times


def profile(fn):
    """(fn()'s value, the device's kernel events, the profile) under
    torch.profiler. The kernel events leave out the ranges that user
    annotations (the optimizer's step) also mark on the device's timeline
    over the kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        value = fn()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return value, kernels, prof


def by_name_and_group(kernels, variant):
    """Device us by kernel name and by group; K5 runs K3's phases, under
    K3's kernel names."""
    per_name, per_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        per_name[e.name] += us
        per_group[group_of(e.name)] += us
    if variant:
        per_group["K5"] = per_group.pop("K3", 0.0)
    return per_name, per_group


def time_fused(args, model, feeder, criterion, lr, clip, data, targets, dev):
    """The train step fused, args.fused steps a call: the "fused" entry."""
    from tggcn_torch.train.loop import make_fused_train_steps

    k = args.fused
    trainable = {"model": model.init(torch.Generator().manual_seed(0))}
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=lr, capturable=True)
    fused = make_fused_train_steps(model, feeder, criterion, optimizer, clip_gradient_at=clip)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    window = lambda n: fused(trainable, [x.expand(n, *x.shape) for x in data],
                             [y.expand(n, *y.shape) for y in targets], generator=gen)
    torch.cuda.reset_peak_memory_stats(dev)
    first_s = timed(lambda: window(k), 1)[0] / 1e3
    window_ms = timed(lambda: window(k), FUSED_WINDOWS)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    wall, kernels, _ = profile(lambda: sum(timed(lambda: window(PROFILED_STEPS), 1)))
    _, per_group = by_name_and_group(kernels, args.variant)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    per_step = lambda us: us / 1e3 / PROFILED_STEPS
    return {"steps": k, "first_call_s": first_s, "window_ms": spread(window_ms),
            "step_ms": statistics.median(window_ms) / k, "peak_gib": peak_gib,
            "profiled_wall_ms_per_step": wall / PROFILED_STEPS,
            "device_busy_ms_per_step": busy_ms / PROFILED_STEPS,
            "device_idle_share": 1.0 - busy_ms / wall,
            "device_idle_share_of_step": 1.0 - busy_ms / PROFILED_STEPS / (
                statistics.median(window_ms) / k),
            "kernel_launches_per_step": len(kernels) / PROFILED_STEPS,
            "groups_ms_per_step": {g: per_step(v) for g, v in
                                   sorted(per_group.items(), key=lambda kv: -kv[1])}}


def range_ops(events, name):
    """(forward, backward): the CPU ops of a torch.profiler profile's
    events inside the ranges called name, and those inside the backward
    nodes of the autograd nodes that these made, each with the autograd
    engine's range around it (where the engine adds up the gradients that
    the node passes on). A backward node and its engine range carry the
    sequence number of the forward op that made it; an op that makes no
    node carries the next one's, so a number that an op outside the ranges
    also carries is left out."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]

    def under(e, test):
        while e is not None:
            if test(e):
                return True
            e = e.cpu_parent
        return False

    in_range = lambda e: e.name == name
    is_node = lambda e: e.scope == BACKWARD_SCOPE or e.name.startswith(ENGINE_RANGE)
    ops = [e for e in cpu if e.sequence_nr >= 0 and not under(e, is_node)]
    made = ({e.sequence_nr for e in ops if under(e, in_range)}
            - {e.sequence_nr for e in ops if not under(e, in_range)})
    return ([e for e in cpu if under(e, in_range)],
            [e for e in cpu if under(e, lambda a: is_node(a) and a.sequence_nr in made)])


def general_scan_split(events, steps):
    """The "general_scan" entry of a profile of steps train steps: the
    general segment scan's forward and backward (the kernels that the ops
    of range_ops(events, GENERAL_SCAN_RANGE) launched), each its device ms
    a step (its kernels run in one stream, one after another: their sum),
    kernels a step and ms a step by group; None where no step ran the
    general scan."""
    forward, backward = range_ops(events, GENERAL_SCAN_RANGE)
    if not forward:
        return None
    result = {}
    for name, ops in (("forward", forward), ("backward", backward)):
        kernels = [k for e in ops for k in e.kernels]    # (name, device, duration us)
        groups = defaultdict(float)
        for k in kernels:
            groups[group_of(k.name)] += k.duration
        result[name] = {
            "busy_ms": sum(k.duration for k in kernels) / 1e3 / steps,
            "kernels": len(kernels) / steps,
            "groups_ms": {g: v / 1e3 / steps
                          for g, v in sorted(groups.items(), key=lambda kv: -kv[1])}}
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                        help="the model's compute dtype")
    parser.add_argument("--stage", choices=("1", "2", "cad120"), default="1",
                        help="the stage of the two-stage protocol (MPHOI), or CAD-120 stage 1")
    parser.add_argument("--variant", choices=tuple(stage1.SERVE_VARIANTS), default=None,
                        help="a stage-1 variant whose segment scan runs through K5 "
                             "(CAD-120: 'dist' only)")
    parser.add_argument("--fused", type=int, default=0, metavar="K",
                        help="also time K steps a call, captured in a CUDA graph")
    args = parser.parse_args(argv)
    stage = stage1
    if args.stage == "2":
        from tggcn_torch.models import stage2 as stage
    elif args.stage == "cad120":
        from tggcn_torch.models import cad120 as stage
    if args.variant and args.variant not in getattr(stage, "SERVE_VARIANTS", {}):
        raise SystemExit(f"profile_step: --variant {args.variant} is not a variant of "
                         f"--stage {args.stage}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    dev = torch.device("cuda", 0)
    b, t, nh, no = (stage.SHAPE[k] for k in ("b", "t", "humans", "objects"))

    kwargs = stage.MODEL_KWARGS
    if args.dtype != "float32":
        kwargs = dict(kwargs, compute_dtype=args.dtype)
    feeder_kwargs, variant = stage.FEEDER_KWARGS, {}
    if args.variant:
        kwargs = dict(kwargs, **stage.SERVE_VARIANTS[args.variant])
        feeder_kwargs, variant = stage.feeder_kwargs(args.variant), dict(variant=args.variant)
    model = select_model("2G-GCN", device=dev, **kwargs)
    trainable = {"model": model.init(torch.Generator().manual_seed(0))}
    criterion, _ = select_loss("2G-GCN", "multiple", stage.DATASET, stage.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **feeder_kwargs)
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name=stage.DATASET)
    data, targets = fetch(stage.make_batch(np.random.default_rng(args.seed), b, t, nh, no,
                                           **variant))
    data = [torch.as_tensor(x, device=dev) for x in data]
    targets = [torch.as_tensor(y, device=dev) for y in targets]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    noise = {"object": gumbel_noise((b, t, no, 2), gen)}
    if args.stage == "2":
        noise["human"] = gumbel_noise((b, t, nh, 2), gen)
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage.TRAIN["lr"])
    step = make_train_step(model, feeder, criterion, optimizer,
                           clip_gradient_at=stage.TRAIN["clip"])
    run_step = lambda: step(trainable, data, targets, noise=noise)

    timed(run_step, 2)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = timed(run_step, args.steps)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    wall, kernels, prof = profile(lambda: sum(timed(run_step, PROFILED_STEPS)))
    per_name, per_group = by_name_and_group(kernels, args.variant)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    recompute = [e.time_range for e in prof.events()
                 if e.name == segment_scan.RECOMPUTE_RANGE
                 and e.device_type == torch.autograd.DeviceType.CPU]
    inside = [(e.time_range.start, e.time_range.end) for e in kernels
              if any(r.start <= e.time_range.start <= r.end for r in recompute)]

    params = trainable["model"]
    rng = np.random.default_rng(args.seed + 1)
    requests = [stage.make_request(rng, b, t, nh, no) for _ in range(args.requests + 1)]
    if args.variant == "dist":
        for request in requests:
            request.update(stage.make_distances(rng, b, t, nh, no))
    with torch.no_grad():
        model.apply(params, **requests[0])
        torch.cuda.synchronize()
        it = iter(requests[1:])
        request_ms = timed(lambda: model.apply(params, **next(it)), args.requests)

    general_scan = general_scan_split(prof.events(), PROFILED_STEPS)
    if general_scan is not None:
        general_scan["share_of_step_busy"] = (general_scan["forward"]["busy_ms"]
                                              + general_scan["backward"]["busy_ms"]) / (
                                                  busy_ms / PROFILED_STEPS)

    fused = None
    if args.fused:
        fused = time_fused(args, model, feeder, criterion, stage.TRAIN["lr"],
                           stage.TRAIN["clip"], data, targets, dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    per_step = lambda us: us / 1e3 / PROFILED_STEPS

    def largest(names, n):
        """The n largest of names by device time, summed over the names
        that share their first 80 characters."""
        short = defaultdict(float)
        for k in names:
            short[k[:80]] += per_name[k]
        return sorted(short.items(), key=lambda kv: -kv[1])[:n]

    top = largest(per_name, 10)
    top_other = largest([k for k in per_name if group_of(k) == "other"], 8)
    print(json.dumps({
        "card": smi, "stage": args.stage, "dtype": args.dtype, "variant": args.variant,
        "train_step_ms": spread(step_ms),
        "request_ms": spread(request_ms),
        "train_step_peak_gib": peak_gib,
        "profiled_steps": PROFILED_STEPS, "profiled_wall_ms_per_step": wall / PROFILED_STEPS,
        "device_busy_ms_per_step": busy_ms / PROFILED_STEPS,
        "device_idle_share": 1.0 - busy_ms / wall,
        "kernel_launches_per_step": len(kernels) / PROFILED_STEPS,
        "recompute_backward_wall_ms_per_step": per_step(sum(r.end - r.start for r in recompute)),
        "recompute_backward_busy_ms_per_step": per_step(_union_us(inside)),
        "groups_ms_per_step": {k: per_step(v) for k, v in
                               sorted(per_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k: per_step(v) for k, v in top},
        "top_other_kernels_ms_per_step": {k: per_step(v) for k, v in top_other},
        **({"general_scan": general_scan} if general_scan else {}),
        **({"fused": fused} if fused else {})}))


if __name__ == "__main__":
    main()
