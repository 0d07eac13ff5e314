"""Benchmark: the 2G-GCN MPHOI stage-1 training step's throughput on one
CUDA card, the port of ``bench.py``.

    python -m tggcn_torch.bench [--device {cuda,cpu}] [--dtype {bfloat16,float32}]
                                [--steps K] [--best-of N] [--tiny]

Prints ONE JSON object as its last line: ``metric``, ``value``, ``unit``,
``vs_baseline`` and the measurement's details (below), or, after a failure,
``error`` and ``detail`` with ``value`` null. A failed run exits non-zero
(``bench.py`` exits 0 with its error line; here no failure exits 0).

Workload (``bench.py:138-214``): the stage-1 model of
``tggcn_torch.models.stage1`` (``model_kwargs``, hidden 512, 'gs' object
decisions) in ``--dtype`` (bfloat16 by default, as ``bench.py`` trains),
its loss bundle and feeder (``TRAIN``, ``FEEDER_KWARGS``), one seeded batch
of ``make_batch`` at B=8, T=167, 2 humans, 4 objects, resident on the card,
and K=``--steps`` (20) train steps fused into one call
(``tggcn_torch.train.loop.make_fused_train_steps``: one step captured in a
CUDA graph and replayed K times), each step with fresh Gumbel noise drawn on
the card. ``--tiny`` (or ``TGGCN_BENCH_TINY=1``) takes B=2, T=12, 2 humans,
2 objects, hidden 16 and 2-step windows; ``--device cpu`` runs only so, on
the kernels' plain versions: a check of the measurement's path, whose
numbers are the CPU's.

The default entry is a supervisor: a probe in a subprocess bounded by
PROBE_TIMEOUT_S (CUDA present, one product on the card), then the
measurement in a child bounded by CHILD_TIMEOUT_S, whose JSON line it
relays. Weights, batch and noise come from seed 0.

Measurement:
* a first fused call (the warm-up: it captures the graph), whose first
  step's losses are held against one step of the plain route
  (``use_kernels=False``) from the same initial weights and noise, within
  5% of each loss (``bench.py:221-263``); a deviation fails the run, which
  then reports no number. TGGCN_BENCH_CROSSCHECK=0 skips it.
* ``--best-of`` (5) trials of one window of K fused steps, interleaved with
  trials of two windows (``bench.py:280-305``), each timed by the host's
  clock up to a synchronize and by CUDA events on the card;
  ``value`` = K * B / the best one-window wall;
  ``device_step_ms`` = the median one-window event span / K.
* ``eager_step_ms``: the median of 20 eager train steps on the kernel
  route, each drawing its noise on the card from the same generator;
  ``request_ms``: the median of 20 served ``stage1.make_request`` requests
  (host->device copy included), each host clock up to a synchronize.
* ``peak_gib``: ``torch.cuda.max_memory_allocated`` over the first call
  (the capture) and the windows, not the cross-check's plain step;
  ``eager_peak_gib`` over the eager steps (the graph's gradients and input
  buffers stay allocated beside them).
* ``card``: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.

``vs_baseline`` is null: ``bench.py``'s reference CPU throughput was
measured on another host.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

METRIC = "mphoi_2ggcn_train_clips_per_sec"
UNIT = "clips/sec/chip"
PROBE_TIMEOUT_S = 120           # a process takes about 8 s to reach the card
CHILD_TIMEOUT_S = 1200          # the kernels' build, the capture and the plain route's step included
SEED = 0
CROSSCHECK_LIMIT = 0.05          # bench.py:262
EAGER_STEPS = REQUESTS = 20
TINY = dict(b=2, t=12, humans=2, objects=2, hidden=16, steps=2)

_PROBE_CODE = """
import sys, torch
dev = sys.argv[1]
if dev == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device")
x = torch.ones(128, 128, device=dev)
assert float((x @ x)[0, 0]) == 128.0
print("probe-ok", dev)
"""


def _emit(record):
    print(json.dumps(record), flush=True)


def _error(error, detail):
    return {"metric": METRIC, "value": None, "unit": UNIT, "vs_baseline": None,
            "error": error, "detail": detail}


def _tail(text, n=3):
    return " | ".join((text or "").strip().splitlines()[-n:])


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="the model's compute dtype")
    parser.add_argument("--steps", type=int, default=None,
                        help="train steps in a fused window (20; 2 with --tiny)")
    parser.add_argument("--best-of", type=int, default=5)
    parser.add_argument("--tiny", action="store_true",
                        default=os.environ.get("TGGCN_BENCH_TINY") == "1")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def supervise(argv):
    """Probe, then measure in a watchdogged child; print one JSON line and
    return the exit code: 0 only for a measurement with a positive value."""
    args = parse_args(argv)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    try:
        probe = subprocess.run([sys.executable, "-c", _PROBE_CODE, args.device],
                               timeout=PROBE_TIMEOUT_S, capture_output=True, text=True,
                               env=env)
        ok = probe.returncode == 0 and "probe-ok" in probe.stdout
        detail = f"probe rc={probe.returncode}: {_tail(probe.stderr or probe.stdout)}"
    except subprocess.TimeoutExpired:
        ok, detail = False, f"probe timed out after {PROBE_TIMEOUT_S} s"
    if not ok:
        _emit(_error("backend_unavailable", detail))
        return 1
    try:
        proc = subprocess.run([sys.executable, "-m", "tggcn_torch.bench", "--child",
                               *(argv if argv is not None else sys.argv[1:])],
                              timeout=CHILD_TIMEOUT_S, capture_output=True, text=True,
                              env=env)
    except subprocess.TimeoutExpired as exc:
        stderr = exc.stderr.decode(errors="replace") if isinstance(exc.stderr, bytes) \
            else exc.stderr
        _emit(_error("measurement_timeout",
                     f"child exceeded {CHILD_TIMEOUT_S} s; stderr tail: {_tail(stderr)}"))
        return 1
    sys.stderr.write(proc.stderr)
    for line in proc.stdout.splitlines():
        try:
            record = json.loads(line)
        except ValueError:
            print(line, file=sys.stderr)
            continue
        if isinstance(record, dict) and record.get("metric") == METRIC:
            _emit(record)
            value = record.get("value")
            good = proc.returncode == 0 and "error" not in record and value and value > 0
            return 0 if good else 1
    _emit(_error("measurement_failed", f"child rc={proc.returncode}, no JSON line; "
                                       f"stderr tail: {_tail(proc.stderr)}"))
    return 1


def measure(args):
    """The measurement (the child): returns the JSON record."""
    import numpy as np
    import torch

    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import (gumbel_noise_stack, make_fused_train_steps,
                                        make_train_step, trainable_parameters)
    from tggcn_torch.train.losses import select_loss

    if args.device == "cpu" and not args.tiny:
        raise ValueError("--device cpu runs only with --tiny")
    size = dict(TINY) if args.tiny else dict(stage1.SHAPE, hidden=stage1.MODEL_KWARGS[
        "hidden_size"], steps=20)
    b, t, nh, no, hidden = (size[k] for k in ("b", "t", "humans", "objects", "hidden"))
    k = args.steps or size["steps"]
    model = select_model("2G-GCN", device=args.device,
                         **dict(stage1.model_kwargs(args.dtype), hidden_size=hidden))
    dev = model.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage1.FEEDER_KWARGS)
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")
    data, targets = fetch(stage1.make_batch(np.random.default_rng(SEED), b, t, nh, no))
    data = [torch.as_tensor(x, device=dev) for x in data]           # resident, as bench.py
    targets = [torch.as_tensor(y, device=dev) for y in targets]
    data_stack = [x.expand(k, *x.shape) for x in data]
    target_stack = [y.expand(k, *y.shape) for y in targets]

    def init():
        return {"model": model.init(torch.Generator().manual_seed(SEED))}

    trainable = init()
    # A capturable Adam keeps its step count on the card (the graph cannot
    # read a host counter); the CPU's Adam refuses capturable=True.
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"],
                                 capturable=cuda)
    fused = make_fused_train_steps(model, feeder, criterion, optimizer,
                                   clip_gradient_at=stage1.TRAIN["clip"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    first_noise = gumbel_noise_stack(gen, k, b, t, nh, no)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    losses, _ = fused(trainable, data_stack, target_stack, noise_stack=first_noise)
    sync()
    first_call_s = time.perf_counter() - start
    capture_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    if not bool(losses.isfinite().all()):
        raise AssertionError(f"fused losses are not finite: {losses.tolist()}")

    max_dev = None
    if os.environ.get("TGGCN_BENCH_CROSSCHECK", "1") != "0":
        check = init()
        step = make_train_step(model, feeder, criterion,
                               torch.optim.Adam(trainable_parameters(check),
                                                lr=stage1.TRAIN["lr"]),
                               clip_gradient_at=stage1.TRAIN["clip"], use_kernels=False)
        want, _, _ = step(check, data, targets,
                          noise={w: v[0] for w, v in first_noise.items()})
        got, want = losses[0].double().cpu(), want.double().cpu()
        max_dev = float(((got - want).abs() / want.abs().clamp(min=1e-3)).max())
        del check, step
        if not max_dev < CROSSCHECK_LIMIT:
            return _error("crosscheck_failed",
                          f"kernel-route first-step losses deviate {max_dev:.3%} from the "
                          f"plain route: {got.tolist()} against {want.tolist()}")

    def window():
        return fused(trainable, data_stack, target_stack, generator=gen)[0]

    def timed(windows):
        """(host ms, card ms or None) of that many windows back to back."""
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        start = time.perf_counter()
        if cuda:
            events[0].record()
        for _ in range(windows):
            out = window()
        if cuda:
            events[1].record()
        sync()
        wall = (time.perf_counter() - start) * 1e3
        if not bool(out.isfinite().all()):
            raise AssertionError(f"fused losses are not finite: {out.tolist()}")
        return wall, events[0].elapsed_time(events[1]) if cuda else None

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ones, twos = [], []
    for _ in range(args.best_of):
        ones.append(timed(1))
        twos.append(timed(2))
    peak_gib = max(capture_gib, torch.cuda.max_memory_allocated(dev) / 2 ** 30) if cuda else None
    best = min(wall for wall, _ in ones)
    device_step_ms = (statistics.median(span for _, span in ones) / k) if cuda else None

    step = make_train_step(model, feeder, criterion, optimizer,
                           clip_gradient_at=stage1.TRAIN["clip"])
    step(trainable, data, targets, generator=gen)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    eager = []
    for _ in range(EAGER_STEPS):
        start = time.perf_counter()
        step(trainable, data, targets, generator=gen)
        sync()
        eager.append((time.perf_counter() - start) * 1e3)
    eager_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None

    rng = np.random.default_rng(SEED + 1)
    requests = [stage1.make_request(rng, b, t, nh, no) for _ in range(REQUESTS + 1)]
    served = []
    with torch.no_grad():
        model.apply(trainable["model"], **requests[0])
        sync()
        for request in requests[1:]:
            start = time.perf_counter()
            model.apply(trainable["model"], **request)
            sync()
            served.append((time.perf_counter() - start) * 1e3)

    card = None
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    return {
        "metric": METRIC, "value": k * b / (best / 1e3), "unit": UNIT, "vs_baseline": None,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu", "card": card,
        "dtype": args.dtype, "steps": k, "best_of": args.best_of,
        "device_step_ms": device_step_ms,
        "device_clips_per_sec": b / (device_step_ms / 1e3) if cuda else None,
        "trials_one_window_ms": [wall for wall, _ in ones],
        "trials_two_window_ms": [wall for wall, _ in twos],
        "first_call_s": first_call_s,
        "eager_step_ms": statistics.median(eager),
        "request_ms": statistics.median(served),
        "crosscheck_max_dev": max_dev,
        "peak_gib": peak_gib, "eager_peak_gib": eager_peak_gib,
    }


def main(argv=None):
    args = parse_args(argv)
    if not args.child:
        return supervise(argv)
    try:
        record = measure(args)
    except Exception as exc:                     # reported as the line, and a non-zero exit
        import traceback

        traceback.print_exc()
        record = _error("measurement_failed", f"{type(exc).__name__}: {exc}")
    _emit(record)
    return 1 if "error" in record else 0


if __name__ == "__main__":
    sys.exit(main())
