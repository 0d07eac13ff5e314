"""Where a step of K1's and K2's bfloat16 cluster kernels goes on the card:
a launch split made on a scratch copy of the sources.

    python -m tggcn_torch.profile_gru_split [--batch B ...] [--reps N]

Copies ``tggcn_torch/csrc`` into a temporary directory once per variant,
edits the copy (below), builds it there and times K1 (``gru_sequence``,
keeping the gates) and K2 (``gru_sequence_bwd``) in bfloat16 at the MPHOI
shape (T=167, S=6, h=512, R = B x 4 rows for each ``--batch``) by CUDA
events, the median of ``--reps`` calls. A variant's kernels compute wrong
values: only its time means anything. Variants:

  full          the sources as they are
  round1, round4, round32
                K1's Round group (``kRound``, 2): 1, 4 or 32 k16 steps
  no_product    every wgmma turned into a PTX comment (its operands stay
                live, so the registers do not change)
  no_exchange   the distributed shared-memory loads read zeros (K1: the
                peers' state; K2: the peers' partials)
  no_gate       K1's gate math and K2's gate backward (C) skipped
  no_barrier    K1's per-step cluster barrier kept only after the last step

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
from tggcn_torch.profile_gru import STREAMS, event_ms, gru_bwd_inputs, gru_inputs

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


VARIANTS = {"full": [], "round1": _round(1), "round4": _round(4), "round32": _round(32),
            "no_product": NO_PRODUCT, "no_exchange": NO_EXCHANGE, "no_gate": NO_GATE,
            "no_barrier": NO_BARRIER}


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gru_split: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    t, h, nr = 167, 512, STREAMS // 2
    inputs = {}
    for b in args.batch:
        gen = torch.Generator(device=dev).manual_seed(b)
        fwd = tuple(x.to(torch.bfloat16) for x in gru_inputs(dev, gen, t, STREAMS, 4 * b, h))
        inputs[b] = (fwd, gru_bwd_inputs(*fwd, nr, gen))
    source_dir, build_dir = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        for name in args.variants:
            with tempfile.TemporaryDirectory() as root:
                _build.CSRC_DIR = edited_copy(VARIANTS[name], root, source_dir)
                _build.BUILD_DIR = Path(root) / "build"
                _build.load_library.cache_clear()
                _build.build(("gru_sequence", "gru_sequence_bwd"))
                row = {"variant": name}
                for b, (fwd, bwd) in inputs.items():
                    row[f"k1_ms_b{b}"] = event_ms(lambda: ops.gru_sequence(*fwd, nr, keep=True),
                                                  args.reps)
                    row[f"k2_ms_b{b}"] = event_ms(lambda: ops.gru_sequence_bwd(*bwd, nr),
                                                  args.reps)
                logs = [_build.library_path(n).with_suffix(".log").read_text()
                        for n in ("gru_sequence", "gru_sequence_bwd")]
                row["spills"] = [line.strip() for log in logs for line in log.splitlines()
                                 if "spill" in line and "0 bytes spill stores" not in line]
                print(json.dumps(row), flush=True)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = source_dir, build_dir
        _build.load_library.cache_clear()


if __name__ == "__main__":
    main()
