"""Where the time of one stage-1 request goes on the card.

    python -m tggcn_torch.profile_forward [--seed N] [--out PATH]
                                          [--stage {1,cad120}] [--dtype D]
                                          [--variant dist] [--batch B]

Runs the stage-1 MPHOI forward (``tggcn_torch.models.stage1``), or with
``--stage cad120`` the CAD-120 one (``tggcn_torch.models.cad120``: its
segment scan the general one; ``--variant dist`` gives it its two distance
tensors and the GeoGCN kernel), at the full width on one CUDA card in the
compute dtype ``--dtype`` under ``torch.profiler``: 3 seeded requests after
one warm-up request, each of the stage's batch, or of ``--batch`` clips
(128: the predict batch of chip_smoke.py's entry_mphoi phase). Prints one JSON object: the card (name and power limit
from nvidia-smi), the wall milliseconds per request (host clock, ended by a
synchronize), the device-busy milliseconds (union of kernel intervals) and
idle share, and device time per kernel name, largest first, grouped as K1
(``gru_step_kernel``, ``gru_cluster_kernel``), K3 (``proj_kernel``, ``mix_kernel``,
``cell_kernel``), K6 (``geo_gcn``) and the rest. ``--out`` also writes the
Chrome trace. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from tggcn_torch.models import stage1
from tggcn_torch.models.registry import select_model

REQUESTS = 3
GROUPS = {"gru_step_kernel": "K1 gru_sequence", "gru_cluster_kernel": "K1 gru_sequence",
          "proj_kernel": "K3 segment_scan_dot",
          "proj_wg": "K3 segment_scan_dot", "mix_kernel": "K3 segment_scan_dot",
          "cell_kernel": "K3 segment_scan_dot", "cell_wg": "K3 segment_scan_dot",
          "geo_gcn": "K6 geo_gcn_fused"}


def _group(name: str) -> str:
    for key, group in GROUPS.items():
        if key in name:
            return group
    return "other"


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="Chrome trace path")
    parser.add_argument("--stage", choices=("1", "cad120"), default="1",
                        help="stage 1 of MPHOI or of CAD-120")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--variant", choices=("dist",), default=None,
                        help="distance-based attention with the GeoGCN kernel")
    parser.add_argument("--batch", type=int, default=None, help="clips a request")
    args = parser.parse_args(argv)

    module = stage1
    if args.stage == "cad120":
        from tggcn_torch.models import cad120 as module
    kwargs = dict(module.MODEL_KWARGS, compute_dtype=args.dtype,
                  **(module.SERVE_VARIANTS[args.variant] if args.variant else {}))
    model = select_model("2G-GCN", **kwargs)                  # CUDA, or raise
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(args.seed)
    shape = dict(module.SHAPE, **({"b": args.batch} if args.batch else {}))
    batches = [module.make_request(rng, **shape) for _ in range(REQUESTS)]
    if args.variant:
        for batch in batches:
            batch.update(module.make_distances(rng, **shape))
    model.apply(params, **batches[0])
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for batch in batches:
            model.apply(params, **batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / REQUESTS
    if args.out:
        prof.export_chrome_trace(args.out)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name, per_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        per_name[e.name] += us
        per_group[_group(e.name)] += us
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    busy_ms /= REQUESTS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "card": smi, "stage": args.stage, "dtype": args.dtype, "variant": args.variant,
        "shape": shape,
        "requests": REQUESTS, "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
        "kernel_launches_per_request": len(kernels) / REQUESTS,
        "groups_ms_per_request": {k: v / 1e3 / REQUESTS
                                  for k, v in sorted(per_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_request": {k[:80]: v / 1e3 / REQUESTS for k, v in top},
    }))


if __name__ == "__main__":
    main()
