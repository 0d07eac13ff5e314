"""The port's data parallelism on the CPU, without JAX: gloo processes on
localhost against one process.

Run as a script, this file is one process of a group (the TGGCN_*
environment contract of ``tggcn_torch/parallel/distributed.py``): it runs
the runs its spec names on a tiny MPHOI workload (hidden 8, T=4, 2 humans,
2 objects, batch 4) through the port's ``train()`` with a mesh, or one
train step from given weights, and writes its results. Imported, it gives
the same workload to the single-process runs.

* The launch contract's errors and the row split.
* Two processes reproduce the single-process loss trajectory over 2
  epochs at rtol 1e-5, atol 1e-6 (``tests/test_distributed.py``'s
  tolerance), while the two processes' counts of unmasked targets differ
  in every train batch (a padded partial batch and -1 in some targets):
  with 'st' decisions, clipping and the multi-task loss learner, and with
  'gs' decisions, batched and frame-indexed noise. The two processes end
  on the same bits.
* Process 0 alone writes the run dir; a 1-epoch run resumed to epoch 2 in
  a new group equals the uninterrupted run.
* Four processes as a 2x2 ('dcn', 'data') mesh equal four as a flat one
  and the single process.
* The CLI's data-parallel errors: more devices than present, a batch the
  processes do not divide. (``resources.num_devices=2 --device cpu``
  against ``num_devices=1`` is ``tests/test_torch_entry.py``'s
  ``test_train_cli_refuses_what_is_not_ported[change0-item 9]``.)
"""

import hashlib
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SEED = 11
EPOCHS = 2
BATCH = 4
N_TRAIN, N_VAL, T, HUMANS, OBJECTS = 7, 5, 4, 2, 2
MODEL = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=8, gcn_node=26,
             message_humans_to_human=True, message_segment=True, message_type="v2",
             message_granularity="v1", message_aggregation="att", attention_style="v3",
             discrete_optimization_strategy="st", object_segment_update_strategy="ind")
MISC = {"budget_loss": {"add": True, "human_weight": 0.5},
        "segmentation_loss": {"add": True, "weight": 0.8},
        "first_level_loss_weight": 0.3, "anticipation_loss_weight": 0.7}
RUNS = {"st_mtll": dict(mtll=True),
        "gs": dict(model={"discrete_optimization_strategy": "gs"}),
        "gs_frame": dict(model={"discrete_optimization_strategy": "gs",
                                "gs_noise": "frame_indexed"})}
WORKER_TIMEOUT = 600


def make_tensors(n, seed):
    """An MPHOI batch list of n examples: the 8 inputs, then the six
    targets, with -1 in a different number of frames of each example's
    segmentation and label targets."""
    rng = np.random.default_rng(seed)
    mask = np.ones((n, OBJECTS), np.float32)
    mask[::3, -1] = 0.0
    dummy = np.zeros((n, 1, 1, 1), np.float32)
    y_seg = rng.integers(0, 2, size=(n, T, HUMANS)).astype(np.float32)
    y_rec = rng.integers(0, 13, size=(n, T, HUMANS)).astype(np.int64)
    for i in range(n):
        y_rec[i, T - i % T:] = -1
        y_seg[i, :i % 3, 0] = -1
    return [rng.normal(size=(n, T, HUMANS, 2152)).astype(np.float32),
            rng.normal(size=(n, T, OBJECTS, 2048)).astype(np.float32), mask,
            np.ones((n, T, HUMANS), np.float32), dummy, dummy, dummy,
            np.full((n,), float(T), np.float32),
            y_seg, y_seg, y_rec, y_rec, y_rec, y_rec]


def loaders():
    from tggcn_torch.data.loading import ArrayDataLoader

    return (ArrayDataLoader(make_tensors(N_TRAIN, SEED), BATCH, shuffle=True, seed=SEED),
            ArrayDataLoader(make_tensors(N_VAL, SEED + 1), BATCH, shuffle=False))


def digest(tree) -> str:
    """A hash of a tree's arrays' bytes, in tree order."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    walk(tree)
    return h.hexdigest()


def run_training(name, mesh=None, log_dir=None, epochs=EPOCHS, resume=False):
    """A run of RUNS[name] through the port's train(): epochs in all,
    resumed from log_dir's last.ckpt when resume."""
    from tggcn_torch.compat.weights import params_from_numpy
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.checkpoint import load_last
    from tggcn_torch.train.loop import train
    from tggcn_torch.train.losses import (select_loss, select_loss_learning_mask,
                                          select_loss_types)
    from tggcn_torch.train.multi_task import init_mtll

    run = RUNS[name]
    model = select_model("2G-GCN", device="cpu", **dict(MODEL, **run.get("model", {})))
    criterion, loss_names = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    mtll = None
    if run.get("mtll"):
        mtll = init_mtll(select_loss_types("2G-GCN", "mphoi"),
                         select_loss_learning_mask("2G-GCN", "mphoi"))
    kwargs = dict(init_params=model.init(torch.Generator().manual_seed(SEED)))
    if resume:
        from tggcn_torch.parallel.distributed import assert_same_across_processes

        last = load_last(log_dir)
        assert_same_across_processes(last["epoch"], "resumed epoch")
        kwargs = dict(init_params=params_from_numpy(last["trainable"]["model"]),
                      init_optimizer_state=last["optimizer"], initial_epoch=last["epoch"] + 1,
                      initial_global_step=last["global_step"],
                      initial_best_val_loss=last["best_val_loss"],
                      initial_checkpoint=last["best_checkpoint"])
        if mtll is not None:
            mtll["log_sds"] = torch.tensor(last["trainable"]["mtll"])
        epochs -= last["epoch"]
    train_loader, val_loader = loaders()
    checkpoint = train(model, train_loader, 1e-3, criterion, epochs, loss_names,
                       clip_gradient_at=5.0,
                       fetch_model_data=select_model_data_fetcher("2G-GCN", "multiple",
                                                                  dataset_name="mphoi"),
                       feed_model_data=select_model_data_feeder("2G-GCN", "multiple",
                                                                dataset_name="mphoi"),
                       val_loader=val_loader, mtll=mtll, num_main_losses=5, seed=42,
                       checkpoint_name="parallel_test", log_dir=log_dir, mesh=mesh, **kwargs)
    return {"train_losses": checkpoint["train_losses"], "val_losses": checkpoint["val_losses"],
            "epoch": checkpoint["epoch"], "digest": digest(checkpoint["model_state_dict"])}


def run_step(spec):
    """One make_train_step step with a mesh from the weights and batch of
    spec['inputs'] (a pickle: model kwargs, the numpy weight tree, the
    global batch, lr, clip): the losses and the updated weights."""
    from tggcn_torch.compat.weights import params_from_numpy, params_to_numpy
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.parallel.mesh import make_mesh
    from tggcn_torch.train.loop import make_train_step, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    with open(spec["inputs"], "rb") as f:
        inputs = pickle.load(f)
    model = select_model("2G-GCN", device="cpu", **inputs["model"])
    trainable = {"model": params_from_numpy(inputs["params"])}
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", inputs["misc"])
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=inputs["lr"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **inputs["feeder"]),
                           criterion, optimizer, clip_gradient_at=inputs["clip"],
                           mesh=make_mesh(device_type="cpu"))
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")
    data, targets = fetch([torch.as_tensor(x) for x in inputs["batch"]])
    losses, raw, _ = step(trainable, data, targets)
    return {"losses": losses.numpy(), "raw": raw.numpy(),
            "params": params_to_numpy(trainable["model"])}


def worker():
    """One process of a launch: join, run the spec's runs, write results."""
    from tggcn_torch.parallel.distributed import maybe_initialize, process_index
    from tggcn_torch.parallel.mesh import make_mesh, make_mesh_2d

    torch.set_num_threads(1)
    assert maybe_initialize(device_type="cpu"), "TGGCN_COORDINATOR contract missing"
    rank = process_index()
    spec = json.loads(os.environ["TGGCN_TEST_SPEC"])
    results = {}
    for key, run in spec.get("runs", {}).items():
        mesh = make_mesh_2d(2, 2, "cpu") if run.get("mesh_2d") else make_mesh(device_type="cpu")
        if run.get("mesh_2d"):
            assert mesh.shape == (2, 2) and mesh.axis_names == ("dcn", "data")
            assert len(mesh.gradient_groups()) == 2
        log_dir = run.get("log_dir")
        if log_dir is not None and run.get("per_rank_dir"):
            log_dir = os.path.join(log_dir, f"rank{rank}")
        results[key] = run_training(run["name"], mesh, log_dir, run.get("epochs", EPOCHS),
                                    run.get("resume", False))
    if "step" in spec:
        results["step"] = run_step(spec["step"])
    with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec, processes=2):
    """Run this file as `processes` gloo processes on spec; every
    process's results, by rank."""
    os.makedirs(spec["out"], exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(processes):
        env = dict(os.environ, TGGCN_COORDINATOR=f"127.0.0.1:{port}",
                   TGGCN_NUM_PROCESSES=str(processes), TGGCN_PROCESS_ID=str(rank),
                   TGGCN_TEST_SPEC=json.dumps(spec), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                                      cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-4000:]}"
    results = []
    for rank in range(processes):
        with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def assert_trajectories_equal(got, want):
    for key in ("train_losses", "val_losses"):
        assert len(got[key]) == len(want[key]) == EPOCHS
        for (total_g, per_g), (total_w, per_w) in zip(got[key], want[key]):
            np.testing.assert_allclose(total_g, total_w, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(per_g, per_w, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def single():
    """Each run of RUNS in this one process, without a mesh."""
    return {name: run_training(name) for name in RUNS}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """RUNS on two processes, each with its own run dir, and the first
    epoch of 'st_mtll' into a shared run dir."""
    tmp = tmp_path_factory.mktemp("parallel")
    runs = {name: dict(name=name, log_dir=str(tmp / name), per_rank_dir=True) for name in RUNS}
    runs["leg1"] = dict(name="st_mtll", log_dir=str(tmp / "shared"), epochs=1)
    return launch({"out": str(tmp / "out"), "runs": runs}), tmp


def test_launch_contract_errors_and_row_split():
    from tggcn_torch.parallel.distributed import (batch_shard, is_main_process,
                                                  make_global_batch, maybe_initialize,
                                                  process_count)
    from tggcn_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="launch contract"):
        maybe_initialize(coordinator_address="127.0.0.1:9999", device_type="cpu")
    with pytest.raises(ValueError, match="launch contract"):
        maybe_initialize(coordinator_address="127.0.0.1:9999", num_processes=2,
                         device_type="cpu")
    with pytest.raises(ValueError, match="launch contract"):
        maybe_initialize(auto=True, device_type="cpu")
    assert not maybe_initialize(device_type="cpu")
    assert process_count() == 1 and is_main_process()
    mesh = make_mesh(3, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.gradient_groups() == (None,)
    shard = batch_shard(6)
    assert (shard.offset, shard.rows, shard.world) == (0, 6, 1)
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(make_global_batch([x])[0], x)


def test_row_split_over_processes(monkeypatch):
    from tggcn_torch.parallel import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    shard = distributed.batch_shard(8)
    assert (shard.offset, shard.rows, shard.global_rows, shard.world) == (4, 2, 8, 4)
    np.testing.assert_array_equal(distributed.make_global_batch([np.arange(8)])[0], [4, 5])
    with pytest.raises(ValueError, match="does not split over 4 processes"):
        distributed.batch_shard(6)


def test_ranks_hold_different_target_counts():
    """The workload's point: per-process means would weigh the processes'
    targets unequally in every train batch."""
    from tggcn_torch.data.feeders import pad_batch

    train_loader, _ = loaders()
    for epoch in range(1, EPOCHS + 1):
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            labels = pad_batch(batch, BATCH, 8)[10]
            counts = [int((half != -1).sum()) for half in np.split(labels, 2)]
            assert counts[0] != counts[1], counts


@pytest.mark.parametrize("name", list(RUNS))
def test_two_processes_match_one(pair, single, name):
    results, _ = pair
    assert_trajectories_equal(results[0][name], single[name])
    assert results[0][name] == results[1][name]          # the same losses and bits


def test_process_zero_owns_the_run_dir(pair):
    _, tmp = pair
    for name in RUNS:
        assert (tmp / name / "rank0" / "last.ckpt").exists()
        assert not (tmp / name / "rank1").exists()


def test_kill_and_resume(pair, tmp_path):
    """A new group resumes the shared run dir's epoch-1 snapshot to epoch 2
    and ends where the uninterrupted two-process run ends."""
    full, tmp = pair
    assert (tmp / "shared" / "last.ckpt").exists()
    resumed = launch({"out": str(tmp_path / "out"),
                      "runs": {"leg2": dict(name="st_mtll", log_dir=str(tmp / "shared"),
                                            resume=True)}})
    assert_trajectories_equal(resumed[0]["leg2"], full[0]["st_mtll"])
    assert resumed[0]["leg2"]["digest"] == full[0]["st_mtll"]["digest"]


def test_2d_mesh_matches_flat(single, tmp_path):
    """Four processes: the gradient summed within each row of a 2x2
    ('dcn', 'data') grid and then across the rows, against the flat sum."""
    runs = {"flat": dict(name="gs"), "mesh_2d": dict(name="gs", mesh_2d=True)}
    results = launch({"out": str(tmp_path / "out"), "runs": runs}, processes=4)
    assert_trajectories_equal(results[0]["mesh_2d"], results[0]["flat"])
    assert_trajectories_equal(results[0]["flat"], single["gs"])
    assert len({r["mesh_2d"]["digest"] for r in results}) == 1


def test_cli_data_parallel_errors(tmp_path):
    from tggcn_torch.parallel.mesh import make_mesh
    from tggcn_torch.train import cli

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"Requested {cards + 1} devices, have {cards}"):
        make_mesh(cards + 1, "cuda")
    with pytest.raises(ValueError, match="must be a multiple of num_devices 3"):
        cli.main(["models=2G-GCN_stage1", "data=mphoi", "resources.num_devices=3",
                  "optimization.batch_size=2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["models=2G-GCN_stage1", "data=mphoi", "resources.num_devices=2"])


def test_fused_steps_refuse_a_group(monkeypatch):
    from tggcn_torch.parallel import distributed
    from tggcn_torch.train import loop

    monkeypatch.setattr(loop, "is_multiprocess", lambda: True)
    with pytest.raises(ValueError, match="one process"):
        loop.make_fused_train_steps(None, None, None, None)
    assert not distributed.is_multiprocess()


if __name__ == "__main__":
    worker()
