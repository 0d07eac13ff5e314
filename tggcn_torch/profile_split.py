"""Where a launch of K1's, K2's and K4's bfloat16 kernels goes on the card:
a launch split made on scratch copies of the sources, with no switch in
them.

    python -m tggcn_torch.profile_split [--kernels gru k4] [--batch B ...] [--reps N]
                                        [--variants NAME ...]

Copies ``tggcn_torch/csrc`` into a temporary directory once per variant,
edits the copy (below), builds it there and times the variant's kernels
in bfloat16, the median of ``--reps`` calls by CUDA events: K1
(``gru_sequence``, keeping the gates) and K2 (``gru_sequence_bwd``) at the
MPHOI shape (T=167, S=6, h=512, R = B x 4 rows), or K4
(``segment_scan_dot_bwd``, T=167, 2 humans, 4 objects, h=512, B clips,
profile_scan's seeded inputs) with each of its two kernels' µs a
launch by the profiler (DA ``segb_dmsgs_att``, R ``segb_carry_ds``),
for each ``--batch``. A variant's kernels compute wrong values: only its
time means anything.

GRU variants (``--kernels gru``):

  full          the sources as they are
  round1, round4, round32
                K1's Round group (``kRound``, 2): 1, 4 or 32 k16 steps
  no_product    every wgmma turned into a PTX comment (its operands stay
                live, so the registers do not change)
  no_exchange   the distributed shared-memory loads read zeros (K1: the
                peers' state; K2: the peers' partials)
  no_gate       K1's gate math and K2's gate backward (C) skipped
  no_barrier    K1's per-step cluster barrier kept only after the last step

K4 variants (``--kernels k4``; the products of tc_gemm.cuh, which K4's
kernels share, are edited in the copy):

  full          the sources as they are
  no_product    every bfloat16 mma.sync a PTX comment (operands live)
  no_rows       no rows copied into the products' rings (cp.async skipped)
  no_weights    no weights copied
  no_copies     neither: the rings run empty
  no_exchange   DA's gather of the cluster's dmsgs tiles reads zeros
  no_da_tail    DA's dpre, da and softmax backward skipped
  no_r_tail     R's attc and phase C skipped (before and after the product)
  r_late_loads  R's phase-C loads issued after the product, where they are
                used, not while its copies run

Prints one JSON line a variant: its ms by kernel and batch, and the spill
lines of its build log. Needs a CUDA device and nvcc.
"""

import argparse
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from tggcn_torch.ops import _build
from tggcn_torch.ops import gru_sequence as ops
from tggcn_torch.ops import segment_scan as scan_ops
from tggcn_torch.profile_gru import STREAMS, event_ms, gru_bwd_inputs, gru_inputs
from tggcn_torch.profile_scan import bwd_inputs, device_ms_by_kernel, scan_inputs

K1 = "gru_cluster_kernel(const bf16"
K2 = "gru_bwd_cluster(CellArgs<bf16> c"
NO_PRODUCT = [("gru_cluster.cuh", None, '"wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "',
               '"// "')]
NO_EXCHANGE = [("gru_sequence.cu", K1, "v[it] = cl::ld_cluster4(cl::map_rank(",
                "v[it] = make_float4(0.f, 0.f, 0.f, 0.f); if (0) cl::ld_cluster4(cl::map_rank("),
               ("gru_sequence_bwd.cu", K2, "cl::ld_cluster2(cl::map_rank(at, p0 + p))",
                "make_float2(0.f, 0.f)")]
NO_GATE = [("gru_sequence.cu", K1, "  for (int k = 0; k < kPairs; ++k) {\n      const int r = pair_row(k)",
            "  for (int k = 0; k < kPairs && T_ < 0; ++k) {\n      const int r = pair_row(k)"),
           ("gru_sequence.cu", K1, "  for (int k = 0; k < kPairs; ++k) {\n      if (!live(k)) continue;\n"
            "      const int r = pair_row(k), c = pair_unit(k), row = row0 + r",
            "  for (int k = 0; k < kPairs && T_ < 0; ++k) {\n      if (!live(k)) continue;\n"
            "      const int r = pair_row(k), c = pair_unit(k), row = row0 + r"),
           ("gru_sequence_bwd.cu", K2, "    // C, as cell_bwd computes it, for units cc and cc + 1.\n"
            "    if (live) {", "    if (live && T_ < 0) {")]
NO_BARRIER = [("gru_sequence.cu", K1,
               "cl::cluster_arrive();\n    if (step + 1 < T_) load_gi(step + 1);\n    cl::cluster_wait();",
               "if (step + 1 < T_) load_gi(step + 1);\n    else { cl::cluster_arrive(); cl::cluster_wait(); }")]


def _round(n):
    return [("gru_sequence.cu", None, "constexpr int kRound = 2;", f"constexpr int kRound = {n};")]


MMA = "__device__ __forceinline__ void mma_bf16("
LOAD = "__device__ __forceinline__ void load_chunk("
DA = "segb_dmsgs_att(DAArgs<bf16> x"
R = "segb_carry_ds(RArgs<bf16> x"
K4_NO_PRODUCT = [("tc_gemm.cuh", MMA, '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 ',
                  '"// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 ')]
K4_NO_ROWS = [("tc_gemm.cuh", LOAD, "  for (int j = 0; j < kXCopies; ++j) {",
               "  for (int j = 0; j < kXCopies && rows < 0; ++j) {")]
K4_NO_WEIGHTS = [("tc_gemm.cuh", LOAD, "  for (int j = 0; j < kWCopies; ++j) {",
                  "  for (int j = 0; j < kWCopies && rows < 0; ++j) {")]
K4_NO_EXCHANGE = [("segment_scan_bwd.cu", DA,
                   "*reinterpret_cast<float4*>(rowbuf + (size_t)li * H + col) = cl::ld_cluster4(",
                   "*reinterpret_cast<float4*>(rowbuf + (size_t)li * H + col) = "
                   "make_float4(0.f, 0.f, 0.f, 0.f); if (0) cl::ld_cluster4(")]
K4_NO_DA_TAIL = [("segment_scan_bwd.cu", DA, "p < nbt * Ng * 2 * kMTile;",
                  "p < nbt * Ng * 2 * kMTile && T_ < 0;"),
                 ("segment_scan_bwd.cu", DA, "p < mine * Ng;", "p < mine * Ng && T_ < 0;"),
                 ("segment_scan_bwd.cu", DA, "  if (tid < mine) {", "  if (tid < mine && T_ < 0) {")]
K4_NO_R_TAIL = [("segment_scan_bwd.cu", R, "    if (!live) return;\n",
                 "    if (!live || T_ > 0) return;\n"),
                ("segment_scan_bwd.cu", R, "  if (live) {\n    // attc",
                 "  if (live && T_ < 0) {\n    // attc")]
K4_LATE_LOADS = [("segment_scan_bwd.cu", R,
                  "    if (!last) in = cell_load_now(cb, next, T_, all_rows, row, unit, H);\n", ""),
                 ("segment_scan_bwd.cu", R,
                  "CellIn{in.r, in.z, in.n, in.hn, wg::widen(in.hprev), wg::widen(in.g),\n"
                  "                           wg::widen(in.u)}",
                  "cell_load(cb, next, T_, all_rows, row, unit, H)")]

VARIANTS = {
    "gru": {"full": [], "round1": _round(1), "round4": _round(4), "round32": _round(32),
            "no_product": NO_PRODUCT, "no_exchange": NO_EXCHANGE, "no_gate": NO_GATE,
            "no_barrier": NO_BARRIER},
    "k4": {"full": [], "no_product": K4_NO_PRODUCT, "no_rows": K4_NO_ROWS,
           "no_weights": K4_NO_WEIGHTS, "no_copies": K4_NO_ROWS + K4_NO_WEIGHTS,
           "no_exchange": K4_NO_EXCHANGE, "no_da_tail": K4_NO_DA_TAIL,
           "no_r_tail": K4_NO_R_TAIL, "r_late_loads": K4_LATE_LOADS}}
SOURCES = {"gru": ("gru_sequence", "gru_sequence_bwd"), "k4": ("segment_scan_bwd",)}
K4_KERNELS = ("segb_dmsgs_att", "segb_carry_ds")


def edited_copy(edits, root, source=_build.CSRC_DIR):
    """A copy of the sources under root with each (file, marker, old, new)
    edit made after the marker (or anywhere, without one); raises if a text
    is missing."""
    out = Path(root) / "csrc"
    shutil.copytree(source, out)
    for name, marker, old, new in edits:
        path = out / name
        text = path.read_text()
        at = text.index(marker) if marker else 0
        if old not in text[at:]:
            raise ValueError(f"{name}: the text to edit is not there: {old[:60]!r}")
        path.write_text(text[:at] + text[at:].replace(old, new))
    return out


def _time(kernel, inputs, reps):
    """{name: ms} of one variant's build: K1 and K2, or K4 with its cluster
    kernels' µs a launch, at each batch of inputs."""
    row = {}
    for b, args in inputs.items():
        if kernel == "gru":
            fwd, bwd = args
            nr = STREAMS // 2
            row[f"k1_ms_b{b}"] = event_ms(lambda: ops.gru_sequence(*fwd, nr, keep=True), reps)
            row[f"k2_ms_b{b}"] = event_ms(lambda: ops.gru_sequence_bwd(*bwd, nr), reps)
        else:
            call = lambda: scan_ops.segment_scan_dot_bwd(**args, scale=512 ** -0.5)
            row[f"k4_ms_b{b}"] = event_ms(call, reps)
            split = device_ms_by_kernel(call, 1)
            for name in K4_KERNELS:
                if name in split and split[name]["launches"]:
                    row[f"{name}_us_b{b}"] = 1e3 * split[name]["ms"] / split[name]["launches"]
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", nargs="+", default=["gru", "k4"], choices=list(VARIANTS))
    parser.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--variants", nargs="+", default=None,
                        help="the variants to run (every variant of each kernel by default)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_split: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    t, h = 167, 512
    source_dir, build_dir = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        for kernel in args.kernels:
            inputs = {}
            for b in args.batch:
                gen = torch.Generator(device=dev).manual_seed(b)
                if kernel == "gru":
                    fwd = tuple(x.to(torch.bfloat16)
                                for x in gru_inputs(dev, gen, t, STREAMS, 4 * b, h))
                    inputs[b] = (fwd, gru_bwd_inputs(*fwd, STREAMS // 2, gen))
                else:
                    fwd = {k: v.to(torch.bfloat16)
                           for k, v in scan_inputs(dev, gen, t, b, 2, 4, h).items()}
                    inputs[b] = bwd_inputs(fwd, gen, h ** -0.5)
            for name, edits in VARIANTS[kernel].items():
                if args.variants and name not in args.variants:
                    continue
                with tempfile.TemporaryDirectory() as root:
                    _build.CSRC_DIR = edited_copy(edits, root, source_dir)
                    _build.BUILD_DIR = Path(root) / "build"
                    _build.load_library.cache_clear()
                    _build.build(SOURCES[kernel])
                    row = {"kernel": kernel, "variant": name, **_time(kernel, inputs, args.reps)}
                    logs = [_build.library_path(n).with_suffix(".log").read_text()
                            for n in SOURCES[kernel]]
                    row["spills"] = [line.strip() for log in logs for line in log.splitlines()
                                     if "spill" in line and "0 bytes spill stores" not in line]
                    print(json.dumps(row), flush=True)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = source_dir, build_dir
        _build.load_library.cache_clear()


if __name__ == "__main__":
    main()
