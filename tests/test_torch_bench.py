"""The port's bench (python -m tggcn_torch.bench) on the CPU.

* ``--device cpu --tiny`` runs the whole measurement on the kernels' plain
  versions (B=2, T=12, 2 humans, 2 objects, hidden 16, 2-step windows) and
  prints one parsable last line: the metric, a positive value, vs_baseline
  null, best_of one-window and two-window trials, and the cross-check.
* Without ``--device cpu`` on a host with no CUDA device the probe fails:
  one error line with value null, and a non-zero exit.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from tggcn_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(*args):
    run = subprocess.run([sys.executable, "-m", "tggcn_torch.bench", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    return run, json.loads(run.stdout.strip().splitlines()[-1])


def test_bench_tiny_on_the_cpu():
    run, record = _run("--device", "cpu", "--tiny", "--best-of", "2")
    assert run.returncode == 0, run.stderr[-2000:]
    assert record["metric"] == bench.METRIC and "error" not in record
    assert record["value"] > 0 and record["vs_baseline"] is None
    assert record["device"] == "cpu" and record["steps"] == 2 and record["best_of"] == 2
    assert len(record["trials_one_window_ms"]) == len(record["trials_two_window_ms"]) == 2
    assert record["value"] == record["steps"] * 2 / (min(record["trials_one_window_ms"]) / 1e3)
    assert record["device_step_ms"] is None          # no card, no device time
    assert 0 <= record["crosscheck_max_dev"] < bench.CROSSCHECK_LIMIT
    assert record["eager_step_ms"] > 0 and record["request_ms"] > 0


def test_bench_without_a_card_fails_with_an_error_line():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    run, record = _run("--tiny")
    assert run.returncode != 0
    assert record["metric"] == bench.METRIC and record["value"] is None
    assert record["error"] == "backend_unavailable" and record["detail"]
