"""Boundaries of the port: no JAX, the card by default, no fallback.

* No file of tggcn_torch/ and not chip_smoke.py imports jax or tggcn.
* tggcn_torch imports with jax made unimportable.
* Entry points run on CUDA unless asked for the CPU, and raise without it.
* A kernel wrapper runs its plain version only for CPU tensors; for any
  other device it launches its kernel or raises. Outside its autograd
  Function, on tensors that require grad, it raises.
* The plain route (use_kernels=False) calls no kernel wrapper, forward or
  backward.
* Configurations outside the slice raise NotImplementedError; the K5
  modes (v1, v4, mean pooling, distances) serve and train in both dtypes,
  and so do the general scan's configurations (relational and 'specific'
  messages, a missing entity edge, no segment messages, a partial set of
  distance tensors) and 'gs' decisions with frame-indexed noise.
* The general segment scan makes no host read and takes no
  data-dependent branch in its loop: no .item(), .tolist(), .cpu(),
  .numpy(), tensor made from host data or Python condition on a tensor.
* No kernel source waits for a block outside its own cluster (no
  cooperative launch, grid sync or programmatic dependent launch), waits at
  a cluster barrier unless it launches its kernels with an explicit cluster
  dimension, or adds with atomics.
* chip_smoke.py fails, printing no result, without a CUDA device.
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn, check_slice
import tggcn_torch.ops.geo_gcn as geo_ops
import tggcn_torch.ops.gru_sequence as gru_ops
import tggcn_torch.ops.segment_scan as scan_ops
from tggcn_torch.ops import _build
from tggcn_torch.ops.gru_sequence import gru_sequence
from tggcn_torch.ops.segment_scan import segment_scan_dot
from tggcn_torch.runtime import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tggcn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
KERNEL_WRAPPERS = [(gru_ops, "gru_sequence"), (gru_ops, "gru_sequence_bwd"),
                   (scan_ops, "segment_scan_dot"), (scan_ops, "segment_scan_dot_bwd"),
                   (scan_ops, "segment_scan_v1"), (scan_ops, "segment_scan_v4"),
                   (scan_ops, "segment_scan_ext"), (geo_ops, "geo_gcn_fused")]
STAGE1 = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=8,
              message_segment=True, message_type="v2", message_granularity="v1",
              message_aggregation="att", attention_style="v3",
              discrete_optimization_strategy="st", object_segment_update_strategy="ind")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_tggcn(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "tggcn"}


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tggcn'] = None\n"
            "import tggcn_torch.models.registry, tggcn_torch.compat.weights\n"
            "import tggcn_torch.ops.gru_sequence, tggcn_torch.ops.segment_scan\n"
            "import tggcn_torch.train.loop, tggcn_torch.train.losses\n"
            "import tggcn_torch.data.feeders, tggcn_torch.bench\n"
            "import tggcn_torch.models.segment_general, tggcn_torch.models.cad120\n"
            "import tggcn_torch.train.cli, tggcn_torch.predict, tggcn_torch.config\n"
            "import tggcn_torch.data.loading, tggcn_torch.data.pipeline\n"
            "import tggcn_torch.data.synthetic, tggcn_torch.eval.engine\n"
            "import tggcn_torch.eval.reporting, tggcn_torch.utils.native\n"
            "import tggcn_torch.visualisation, tggcn_torch.train.logging\n"
            "import tggcn_torch.models.baselines, tggcn_torch.models.streaming\n"
            "import tggcn_torch.parallel.distributed, tggcn_torch.parallel.mesh\n"
            "import tggcn_torch.analysis, tggcn_torch.data.cross_validation\n"
            "import tggcn_torch.utils.drawing\n"
            "print('ok')")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        select_model("2G-GCN", **STAGE1)
    with pytest.raises(RuntimeError, match="CUDA"):
        select_model("2G-GCN", device="cuda", **STAGE1)
    assert select_model("2G-GCN", device="cpu", **STAGE1).device.type == "cpu"


def test_resolve_device_pins_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _gru_args(device):
    t, s, r, h = 3, 2, 4, 8
    return (torch.zeros(t, s, r, 3 * h, device=device), torch.zeros(s, h, 3 * h, device=device),
            torch.zeros(s, 3 * h, device=device), torch.zeros(s, r, h, device=device))


def test_wrappers_take_the_plain_version_only_on_cpu():
    """'meta' tensors are neither CPU nor CUDA: the wrappers must refuse
    them rather than fall back to the plain version."""
    before = gru_sequence.launches, segment_scan_dot.launches
    assert gru_sequence(*_gru_args("cpu")).shape == (3, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        gru_sequence(*_gru_args("meta"))
    seg = [torch.zeros(2, 3, 1, 2, 24, device="meta")] * 2 + [None] * 13
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        segment_scan_dot(*seg, scale=1.0)
    assert (gru_sequence.launches, segment_scan_dot.launches) == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc the first launch raises; nothing is built on import."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit under /usr/local/cuda")
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("gru_sequence")
    assert not (tmp_path / "build").exists()


def test_library_path_follows_sources():
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")
        assert (_build.CSRC_DIR / f"{name}.cu").exists()


# Waits on blocks of the whole grid: forbidden in every source. A block may
# wait only for the blocks of its own cluster, which the card schedules
# together or not at all: a cluster wait may appear only in a source that
# launches with an explicit cluster dimension (CLUSTER_LAUNCHES).
GRID_WAITS = ("cudaLaunchCooperativeKernel", "cudaLaunchAttributeCooperative", "this_grid",
              "griddepcontrol", "cudaGridDependencySynchronize")
CLUSTER_WAITS = ("barrier.cluster", "cluster.sync(", "this_cluster", "cluster_sync(")
CLUSTER_LAUNCHES = ("__cluster_dims__", "cudaLaunchAttributeClusterDimension")
# PTX's atomic and reduction instructions, as whole words (not the tail of
# "shared.global" in a copy's state spaces).
PTX_ATOMICS = re.compile(r"\b(atom|red)\.")


def source_faults(text):
    """What the rule for kernel sources finds in a source's text: grid-wide
    waits, cluster waits without a cluster launch, atomics."""
    faults = [f"waits on the grid ({word})" for word in GRID_WAITS if word in text]
    if not any(word in text for word in CLUSTER_LAUNCHES):
        faults += [f"waits at a cluster barrier ({word}) with no cluster launch"
                   for word in CLUSTER_WAITS if word in text]
    if "atomic" in text.replace("no atomics", ""):
        faults.append("uses an atomic")
    found = PTX_ATOMICS.search(text)
    if found:
        faults.append(f"uses the PTX atomic {found.group(0)}")
    return faults


@pytest.mark.parametrize("path", sorted(p.name for p in _build.CSRC_DIR.iterdir()
                                        if p.suffix in (".cu", ".cuh")))
def test_kernels_wait_on_no_other_block(path):
    """No kernel source waits for a block outside its own cluster (no
    cooperative launch, grid sync or programmatic dependent launch: phase
    order comes from stream order), waits at a cluster barrier without
    launching its kernels with an explicit cluster dimension, or adds with
    atomics. A barrier orders and cannot change a bit, and a cluster's
    blocks are scheduled together or not at all, so it cannot wait forever;
    atomics sum in an order that changes from run to run. So two identical
    train steps give the same gradient bits."""
    assert source_faults((_build.CSRC_DIR / path).read_text()) == [], path


@pytest.mark.parametrize("line", ["atom.global.add.f32 %0, [%1], %2;",
                                  "red.shared.add.u32 [%0], 1;", "red.global.add.f32 [%0], %1;",
                                  "atomicAdd(p, 1.f);", "barrier.cluster.arrive;",
                                  "cluster.sync();", "cg::this_cluster().sync();",
                                  "cute::cluster_sync();", "__cluster_dims__(2, 1, 1)"])
def test_source_checks_catch_atomics_and_cluster_waits(line):
    """The checks above see each form an atomic or a cluster wait takes in a
    source, and the form a cluster launch takes, and pass a TMA copy's state
    spaces."""
    caught = (any(word in line for word in GRID_WAITS + CLUSTER_WAITS + CLUSTER_LAUNCHES)
              or "atomic" in line or PTX_ATOMICS.search(line) is not None)
    assert caught, line
    assert PTX_ATOMICS.search("cp.async.cg.shared.global [%0], [%1], 16;") is None


CLUSTER_LAUNCH = "attr.id = cudaLaunchAttributeClusterDimension;\n"


@pytest.mark.parametrize("text,faults", [
    ("asm volatile(\"barrier.cluster.wait.acquire.aligned;\");\n", 1),
    ("cg::this_cluster().sync();\n", 1),
    (CLUSTER_LAUNCH + "asm volatile(\"barrier.cluster.arrive.release.aligned;\");\n", 0),
    ("__global__ void __cluster_dims__(2, 1, 1) k() { cute::cluster_sync(); }\n", 0),
    (CLUSTER_LAUNCH + "cg::this_grid().sync();\n", 1),
    (CLUSTER_LAUNCH + "asm volatile(\"griddepcontrol.wait;\");\n", 1),
    (CLUSTER_LAUNCH + "atomicAdd(p, 1.f);\n", 1),
], ids=["cluster-barrier-alone", "cg-cluster-sync-alone", "cluster-barrier-with-launch",
        "cluster-dims-with-sync", "grid-sync-with-cluster-launch",
        "dependent-launch-with-cluster-launch", "atomic-with-cluster-launch"])
def test_cluster_waits_need_a_cluster_launch(text, faults):
    """A cluster barrier passes only beside an explicit cluster launch; a
    grid-wide wait or an atomic fails beside one as well."""
    assert len(source_faults(text)) == faults, source_faults(text)


def _tiny_batch(humans=2, objects=2):
    rng = np.random.default_rng(0)
    return dict(x_human=rng.normal(size=(1, 2, humans, 2152)).astype(np.float32),
                x_objects=rng.normal(size=(1, 2, objects, 2048)).astype(np.float32),
                objects_mask=np.ones((1, objects), np.float32))


def _distances():
    """The three distance tensors of a _tiny_batch."""
    from tggcn_torch.models import stage1

    return stage1.make_distances(np.random.default_rng(1), 1, 2, 2, 2)


def _assert_trains(model, params, batch):
    """A train call gives a finite loss and finite gradients, and the
    segment scan's input weights get one."""
    from tggcn_torch.train.loop import model_parameters

    for p in model_parameters(params):
        p.requires_grad_(True)
    outputs, _ = model.apply(params, train=True, **batch)
    loss = sum(o.mean() for o in outputs[2:])
    loss.backward()
    grads = [p.grad for p in model_parameters(params) if p.grad is not None]
    assert bool(torch.isfinite(loss)) and grads
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(params["human_segment_rnn_fcell"]["w_ih"].grad.abs().max()) > 0


# Configurations of the K5 modes and of the general scan that serve and train.
TRAINS = ({"message_aggregation": "mp"}, {"attention_style": "v1"}, {"attention_style": "v4"},
          {"compute_dtype": "bfloat16"}, {"message_type": "relational"},
          {"message_granularity": "specific"}, {"message_humans_to_human": False},
          {"message_segment": False}, {"gs_noise": "frame_indexed"})


@pytest.mark.parametrize("change", [
    {"message_type": "relational"}, {"message_granularity": "specific"},
    {"message_aggregation": "mp"}, {"attention_style": "v1"}, {"attention_style": "v4"},
    {"gs_noise": "frame_indexed"}, {"message_humans_to_human": False},
    {"object_segment_update_strategy": "sah"},
    {"compute_dtype": "float16"}, {"compute_dtype": "bfloat16"}, {"message_segment": False},
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_outside_the_slice_raises(change):
    """Configurations outside the port raise (float16). Mean pooling and
    v1/v4 attention (K5) serve and train on the CPU, and so does v1
    attention in bfloat16; so do relational and 'specific' messages, a
    segment level without the humans-to-human edge and one without segment
    messages (the general scan), and frame-indexed Gumbel noise; 'sah'
    (with the one human it needs) serves."""
    kwargs = {**STAGE1, **change}
    if change == {"compute_dtype": "bfloat16"}:
        kwargs["attention_style"] = "v1"
    if change == {"gs_noise": "frame_indexed"}:
        kwargs["discrete_optimization_strategy"] = "gs"
    if change not in TRAINS + ({"object_segment_update_strategy": "sah"},):
        with pytest.raises(NotImplementedError, match="slice"):
            check_slice(TGGCNConfig.from_kwargs(**kwargs))
        return
    model = select_model("2G-GCN", device="cpu", **kwargs)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tiny_batch(humans=1)
    outputs, _ = model.apply(params, **batch)
    assert all(bool(torch.isfinite(o).all()) for o in outputs)
    if change in TRAINS:
        _assert_trains(model, params, batch)


def test_training_and_distances_raise():
    """Training is in the slice in float32 and bfloat16 in every segment
    mode: a bfloat16 train call with v1 attention, and distance-based
    attention (K5 in 'ext' mode), serve and train; so does a train call
    with a partial set of distance tensors (the general scan)."""
    model = select_model("2G-GCN", device="cpu", **STAGE1)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tiny_batch()
    bf16 = select_model("2G-GCN", device="cpu",
                        **{**STAGE1, "attention_style": "v1", "compute_dtype": "bfloat16"})
    _assert_trains(bf16, bf16.init(torch.Generator().manual_seed(0)), batch)
    outputs, _ = model.apply(params, **batch, **_distances())
    assert all(bool(torch.isfinite(o).all()) for o in outputs)
    _assert_trains(model, params, dict(batch, **_distances()))
    _assert_trains(model, model.init(torch.Generator().manual_seed(0)),
                   dict(batch, human_object_distances=_distances()["human_object_distances"]))


@pytest.mark.parametrize("given", ["human_object_distances",
                                   "human_object_distances,object_object_distances"])
def test_partial_distance_set_raises(given):
    """JAX runs a partial set of distance tensors through its XLA scans;
    the port serves it through its general scan (no kernel mode applies)
    and no longer raises: finite outputs that differ from the request
    without distances."""
    from tggcn_torch.models.tggcn import segment_mode

    model = select_model("2G-GCN", device="cpu", **STAGE1)
    params = model.init(torch.Generator().manual_seed(0))
    dists = {k: torch.tensor(v) for k, v in _distances().items() if k in given.split(",")}
    three = [dists.get(k) for k in ("human_human_distances", "human_object_distances",
                                     "object_object_distances")]
    assert segment_mode(model.config, three) is None
    outputs, _ = model.apply(params, **_tiny_batch(), **dists)
    plain, _ = model.apply(params, **_tiny_batch())
    assert all(bool(torch.isfinite(o).all()) for o in outputs)
    assert any(not torch.equal(a, b) for a, b in zip(outputs, plain))


HOST_READS = ("item", "tolist", "cpu", "numpy", "new_tensor")


def test_general_scan_makes_no_host_read():
    """The general scan's module calls no method that reads a tensor back
    to the host or copies host data to the device, builds no tensor with
    torch.tensor, and tests no tensor in an if, while or assert."""
    path = ROOT / "tggcn_torch" / "models" / "segment_general.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            assert node.func.attr not in HOST_READS, f"line {node.lineno}: .{node.func.attr}"
            assert not (node.func.attr in ("tensor", "as_tensor")
                        and getattr(node.func.value, "id", None) == "torch"), node.lineno
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            for sub in ast.walk(node.test):
                assert not (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in ("any", "all", "sum", "max", "min")), \
                    f"line {node.lineno}: a condition on a tensor"


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        run = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
        lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
        assert not any(json.loads(line).get("ok") for line in lines)


@pytest.mark.parametrize("body,marker", [
    ("time.sleep(60)", "Timeout"),                    # a hang: the watchdog ends the run
    ("raise AssertionError('boom')", "phase k3 FAILED"),
], ids=["hang", "error"])
def test_chip_smoke_phase_ends_the_run(body, marker):
    """A phase that hangs or fails ends chip_smoke with a non-zero exit and
    the phase's name on its last lines."""
    code = ("import time, chip_smoke\n"
            "chip_smoke.PHASE_LIMIT_S['k3'] = 2\n"
            "with chip_smoke.phase('k3'):\n"
            f"    {body}\n"
            "print('not reached')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode != 0
    assert run.stdout.splitlines()[-1].startswith("phase k3")
    assert "not reached" not in run.stdout
    assert marker in run.stdout + run.stderr


def test_plain_route_calls_no_kernel_wrapper(monkeypatch):
    """apply(..., use_kernels=False) reaches the kernels' plain versions
    directly, however the wrappers are bound, and computes what the
    wrapper route computes."""
    import tggcn_torch.ops.gru_sequence as gru_mod
    import tggcn_torch.ops.segment_scan as scan_mod
    from tggcn_torch.models import stage1

    model = select_model("2G-GCN", device="cpu", **dict(stage1.MODEL_KWARGS, hidden_size=8))
    params = model.init(torch.Generator().manual_seed(0))
    batch = stage1.make_request(np.random.default_rng(0), b=2, t=5, humans=2, objects=3)
    want, _ = model.apply(params, **batch)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the plain route")

    for mod, name in KERNEL_WRAPPERS:
        monkeypatch.setattr(mod, name, refuse)
    got, _ = model.apply(params, use_kernels=False, **batch)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        model.apply(params, **batch)


@pytest.mark.parametrize("flipped_rows,margin,dropped,filtered", [
    ([], 0.0, 0, None), ([1], 1e-6, 1, None), ([0, 2], 1e-6, None, None),
    ([1], 0.2, None, None), ([1], 1e-6, 1, "threshold"), ([1], 0.05, None, "threshold"),
    ([1], 1e-6, 1, "tie"), ([0, 2], 1e-6, None, "tie"), ([1], 0.3, None, "tie")],
    ids=["none", "one_marginal_row", "two_rows", "away_from_threshold",
         "filtered_at_threshold_0.1", "filtered_away_from_threshold_0.1",
         "filtered_neighbour_tie", "filtered_two_rows_of_ties", "filtered_away_from_neighbour"])
def test_chip_smoke_drops_at_most_one_row(flipped_rows, margin, dropped, filtered):
    """chip_smoke's forward comparison leaves out at most one batch row per
    request for marginal decision flips, and fails on any other flip. With
    filtered decisions (stage 2: local maxima at threshold 0.1), a flip is
    marginal near the configured threshold or near the neighbour whose
    comparison changed."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from tggcn_torch.nn.temporal import filter_soft_decisions

    b, t, o = 3, 4, 2
    out = [torch.rand(b, t, 2, generator=torch.Generator().manual_seed(0))]
    soft_w = torch.full((b, t, o), 0.25)
    soft_g = soft_w.clone()
    for row in flipped_rows:
        if filtered == "threshold":        # frame 1 a local maximum, at 0.1 in one run
            soft_w[row, :, 0] = soft_g[row, :, 0] = 0.05
            soft_w[row, 1, 0], soft_g[row, 1, 0] = 0.1 - margin, 0.1 + margin
        elif filtered == "tie":            # frames 1 and 2 tie in one run, not in the other
            soft_w[row, 1, 0] = soft_g[row, 1, 0] = 0.6
            soft_w[row, 2, 0], soft_g[row, 2, 0] = 0.6 + margin, 0.6 - margin
        else:
            soft_w[row, 1, 0], soft_g[row, 1, 0] = 0.5 - margin, 0.5 + margin
    if filtered:
        rule = dict(threshold=0.1, filtered=True)
        hard = lambda soft: filter_soft_decisions(soft, 0.1)
    else:
        rule = None
        hard = lambda soft: (soft > 0.5).float()
    got = ([out[0].clone()], {"object_decisions": (hard(soft_g), soft_g)})
    want = ([out[0].clone()], {"object_decisions": (hard(soft_w), soft_w)})
    flips = int((hard(soft_g) != hard(soft_w)).sum())
    assert flips >= len(flipped_rows)
    for row in flipped_rows:
        got[0][0][row] += 1.0              # a flipped row's outputs may differ
    if dropped is None:
        with pytest.raises(AssertionError):
            chip_smoke.compare_forward(torch, got, want, "request", rule=rule)
    else:
        err, n_flips, n = chip_smoke.compare_forward(torch, got, want, "request", rule=rule)
        assert (err, n_flips, n) == (0.0, flips, dropped)


def _seg_args(requires_grad):
    t, b, nh, no, h = 2, 1, 1, 2, 4
    shapes = dict(gi_h=(2, t, b, nh, 3 * h), gi_o=(2, t, b, no, 3 * h), u_h=(t, b, nh),
                  u_o=(t, b, no), w_from=(4, h, h), b_from=(4, h), w_msg_h=(2, 2 * h, 3 * h),
                  w_msg_o=(2, 2 * h, 3 * h), w_hh_h=(2, h, 3 * h), w_hh_o=(2, h, 3 * h),
                  b_hh_h=(2, 3 * h), b_hh_o=(2, 3 * h), obj_mask=(b, no))
    args = {k: torch.zeros(v, requires_grad=requires_grad and k == "w_from")
            for k, v in shapes.items()}
    streamed = dict(hprev_h=torch.zeros(2, t, b, nh, h), hprev_o=torch.zeros(2, t, b, no, h),
                    m_h=torch.zeros(2, t, b, nh, 2 * h), m_o=torch.zeros(2, t, b, no, 2 * h),
                    gates_h=torch.zeros(2, t, b, nh, 4 * h),
                    gates_o=torch.zeros(2, t, b, no, 4 * h),
                    atts=torch.zeros(2, t, b, nh + no, nh + no),
                    g_h=torch.zeros(2, t, b, nh, h), g_o=torch.zeros(2, t, b, no, h),
                    g_att=torch.zeros(2, t, b, nh, no))
    h0 = dict(h0_h=torch.zeros(2, b, nh, h), h0_o=torch.zeros(2, b, no, h))
    return args, streamed, h0


# What K4 takes of the scan's inputs besides what K3 kept.
BWD_WEIGHTS = ("u_h", "u_o", "w_from", "w_msg_h", "w_msg_o", "w_hh_h", "w_hh_o")


@pytest.mark.parametrize("wrapper", [name for _, name in KERNEL_WRAPPERS])
def test_wrapper_outside_its_function_raises(wrapper):
    """A kernel wrapper given a tensor that requires grad, with grad mode on,
    raises instead of returning an output without autograd history; under
    no_grad, and through the autograd Function, it runs."""
    gi, w_hh, b_hh, h0 = _gru_args("cpu")
    hprev = g = torch.zeros(gi.shape[:-1] + (gi.shape[-1] // 3,))
    gates = torch.zeros_like(gi)
    seg, streamed, seg_h0 = _seg_args(requires_grad=True)
    h, e = seg["w_hh_h"].shape[1], seg["gi_h"].shape[3] + seg["gi_o"].shape[3]
    geo = [torch.zeros(3, 5, 4)] + [torch.zeros(s) for s in (
        (4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128))]
    calls = {"gru_sequence": lambda: gru_ops.gru_sequence(gi, w_hh, b_hh, h0),
             "gru_sequence_bwd": lambda: gru_ops.gru_sequence_bwd(gi, hprev, g, gates, w_hh),
             "segment_scan_dot": lambda: scan_ops.segment_scan_dot(**seg, **seg_h0, scale=1.0),
             "segment_scan_dot_bwd": lambda: scan_ops.segment_scan_dot_bwd(
                 **{k: v for k, v in seg.items() if k in BWD_WEIGHTS}, **streamed, scale=1.0),
             "segment_scan_v1": lambda: scan_ops.segment_scan_v1(
                 **seg, **seg_h0, w_att=torch.zeros(4, 2 * h), b_att=torch.zeros(4)),
             "segment_scan_v4": lambda: scan_ops.segment_scan_v4(
                 **seg, **seg_h0, w_att=torch.zeros(4, h, h), b_att=torch.zeros(4)),
             "segment_scan_ext": lambda: scan_ops.segment_scan_ext(
                 **seg, **seg_h0, att_ext=torch.zeros(seg["u_h"].shape[:2] + (e, e))),
             "geo_gcn_fused": lambda: geo_ops.geo_gcn_fused(*geo)}
    geo[1].requires_grad_(True)
    w_hh.requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd Function"):
        calls[wrapper]()
    with torch.no_grad():
        calls[wrapper]()
    out = gru_ops.gru_sequence_autograd(gi, w_hh, b_hh, h0)
    out.sum().backward()
    assert w_hh.grad is not None
    h_h, _, _ = scan_ops.segment_scan_dot_autograd(**seg, **seg_h0, scale=1.0)
    h_h.sum().backward()
    assert seg["w_from"].grad is not None
    geo_ops.geo_gcn_fused_autograd(*geo).sum().backward()
    assert geo[1].grad is not None


@pytest.mark.parametrize("variant", ["dist", "mp", "v1", "v4"])
def test_plain_serving_modes_call_no_kernel_wrapper(monkeypatch, variant):
    """Serving each K5 variant (distances with the GeoGCN kernel on) with
    use_kernels=False reaches no kernel wrapper and computes what the
    wrapper route computes on the CPU."""
    from tggcn_torch.models import stage1

    model = select_model("2G-GCN", device="cpu", **dict(stage1.MODEL_KWARGS, hidden_size=8,
                                                        **stage1.SERVE_VARIANTS[variant]))
    params = model.init(torch.Generator().manual_seed(0))
    batch = dict(stage1.make_request(np.random.default_rng(0), b=1, t=2, humans=2, objects=2))
    if variant == "dist":
        batch.update(_distances())
    want, _ = model.apply(params, **batch)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the plain route")

    for mod, name in KERNEL_WRAPPERS:
        monkeypatch.setattr(mod, name, refuse)
    got, _ = model.apply(params, use_kernels=False, **batch)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        model.apply(params, **batch)


def test_plain_train_step_launches_nothing(monkeypatch):
    """A train step on the plain route (use_kernels=False) reaches no kernel
    wrapper, forward or backward, and moves no launch counter."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.train.loop import make_train_step, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device="cpu", **dict(stage1.MODEL_KWARGS, hidden_size=8))
    trainable = {"model": model.init(torch.Generator().manual_seed(0))}
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **stage1.FEEDER_KWARGS),
                           criterion, optimizer, use_kernels=False)
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")
    data, targets = fetch(stage1.make_batch(np.random.default_rng(0), 2, 4, 2, 3))
    counts = [getattr(mod, name).launches for mod, name in KERNEL_WRAPPERS]

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the plain route")

    for mod, name in KERNEL_WRAPPERS:
        monkeypatch.setattr(mod, name, refuse)
    losses, _, _ = step(trainable, data, targets)
    assert torch.isfinite(losses).all()
    monkeypatch.undo()
    assert [getattr(mod, name).launches for mod, name in KERNEL_WRAPPERS] == counts


@pytest.mark.parametrize("variant", ["full", "round1", "round4", "round32", "no_product",
                                     "no_exchange", "no_gate", "no_barrier"])
def test_gru_split_variants_edit_the_sources(variant, tmp_path):
    """Each GRU launch-split variant of profile_split finds the text it edits
    in the current sources (it raises on a stale edit), and edits only its
    scratch copy."""
    _check_split_variant("gru", variant, tmp_path)


def _check_split_variant(kernel, variant, tmp_path):
    from tggcn_torch import profile_split

    before = {p.name: p.read_text() for p in _build.CSRC_DIR.iterdir()}
    copy = profile_split.edited_copy(profile_split.VARIANTS[kernel][variant], tmp_path)
    changed = {p.name for p in copy.iterdir() if p.read_text() != before[p.name]}
    assert bool(changed) == (variant != "full"), changed
    assert {p.name: p.read_text() for p in _build.CSRC_DIR.iterdir()} == before


@pytest.mark.parametrize("variant", ["full", "no_product", "no_rows", "no_weights", "no_copies",
                                     "no_exchange", "no_da_tail", "no_r_tail", "r_late_loads"])
def test_k4_split_variants_edit_the_sources(variant, tmp_path):
    """Each K4 launch-split variant of profile_split finds the text it edits
    in the current sources, and edits only its scratch copy."""
    _check_split_variant("k4", variant, tmp_path)


def test_segment_scan_bwd_route_is_checked():
    """segment_scan_dot_bwd takes route None, 'cluster' or 'steps' and
    raises on any other, on the CPU as on the card."""
    with pytest.raises(ValueError, match="route"):
        scan_ops.segment_scan_dot_bwd(*([None] * 17), scale=1.0, route="both")


@pytest.mark.parametrize("h,kernels", [(512, ("segb_dmsgs_att", "segb_carry_ds")),
                                       (520, ("segb_dmsgs", "segb_carry"))])
def test_chip_smoke_k4_bytes_follow_the_route(h, kernels):
    """chip_smoke's L2 byte count of K4's bfloat16 products names the
    kernels of the shape's route; at MPHOI's batch of 8 the two-launch
    route copies what the per-step kernels D and R copy (each DA block
    copies its columns and the tile's rows of both cells)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_bytes", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.k4_l2_bytes(8, 2, 4, h)
    assert tuple(got) == kernels
    if h == 512:
        per_block = (32 + 16) * 3 * h * 2 + (32 + 32) * 3 * h * 2
        assert got["segb_dmsgs_att"] == 2 * 2 * 16 * per_block == 22020096
        assert got["segb_carry_ds"] == 26214400
