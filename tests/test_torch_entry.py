"""The port's entry points on the CPU, without JAX: the train CLI
(``python -m tggcn_torch.train``), the predict CLI (``python -m
tggcn_torch.predict``) and the run dir between them, at hidden 16, T <= 42
(downsampled: 14), batch 2, on the synthetic datasets of
``tggcn_torch/data/synthetic.py``, with ``--device cpu``.

* Train then predict for MPHOI stage 1, CAD-120 stage 1 and Bimanual:
  the run dir is named as the JAX package names it
  (``tests/test_integration.py``), holds ``.hydra/config.yaml``,
  ``<name>.ckpt`` and ``last.ckpt``; predict gives labels of the targets'
  shape at full FPS and the metrics run.
* A run resumed from ``last.ckpt`` equals the uninterrupted run: losses
  and best weights bit for bit.
* Stage 2 warm-starts from the stage-1 run dir and reports the number of
  parameter leaves it took (the merge of the stage-1 tree into its init).
* ``--cross_validate`` over two sibling folds prints the summaries.
* A JAX-written checkpoint pickles scikit-learn's StandardScaler: the
  port always reads it as its own StandardScaler (here with scikit-learn
  hidden, as the card has none).
* ``resources.num_devices=2`` trains on two gloo processes and gives the
  one-process run's losses; the train CLI refuses the orbax checkpoint
  backend (NotImplementedError saying it is not ported); both CLIs raise
  without a CUDA device unless given ``--device cpu``. (The baselines' CLI runs are in
  ``tests/test_torch_baselines.py``.)
"""

import argparse
import builtins
import io
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from tggcn_torch import predict as predict_cli
from tggcn_torch.config import compose
from tggcn_torch.data.loading import ScalerUnpickler, StandardScaler
from tggcn_torch.data.synthetic import (generate_bimanual_dataset, generate_cad120_dataset,
                                        generate_mphoi_dataset)
from tggcn_torch.models.registry import select_model
from tggcn_torch.train import cli as train_cli
from tggcn_torch.train.checkpoint import count_merged, load_model_weights, merge_params

SMALL = ["parameters.hidden_size=16", "optimization.batch_size=2",
         "optimization.val_fraction=0.25"]
RUN = "hs16_e{epochs}_bs2_lr0.0001_{threshold}_{subject}"


def mphoi_overrides(paths, root, subject="Subject45", epochs=2, models="2G-GCN_stage1"):
    return [f"models={models}", "data=mphoi",
            *(f"data.{k}={paths[k]}" for k in ("path", "path_zarr", "path_obb_zarr",
                                                 "path_hbb_zarr", "path_hps_zarr")),
            f"data.cross_validation_test_subject={subject}", *SMALL,
            f"optimization.epochs={epochs}",
            f"logging.root_log_dir={root}/outputs/mphoi/2G-GCN", "--device", "cpu"]


def run_dir(root, dataset, epochs=2, threshold=0.5, subject="Subject45"):
    return os.path.join(str(root), "outputs", dataset, "2G-GCN",
                        RUN.format(epochs=epochs, threshold=threshold, subject=subject))


@pytest.fixture(scope="module")
def mphoi(tmp_path_factory):
    """A synthetic MPHOI dataset and a 2-epoch stage-1 run on it."""
    root = tmp_path_factory.mktemp("mphoi")
    paths = generate_mphoi_dataset(str(root / "data"), num_videos=8, min_len=24, max_len=42,
                                   seed=11)
    checkpoint = train_cli.main(mphoi_overrides(paths, root))
    return root, paths, checkpoint


def _check_run(path, checkpoint, epochs, heads, humans):
    assert os.path.isdir(path), os.listdir(os.path.dirname(path))
    name = os.path.basename(path)
    for f in (".hydra/config.yaml", f"{name}.ckpt", "last.ckpt"):
        assert os.path.exists(os.path.join(path, f)), f
    assert len(checkpoint["train_losses"]) == len(checkpoint["val_losses"]) == epochs
    assert np.isfinite(checkpoint["train_losses"][-1][0])
    outputs, targets, test_ids = predict_cli.predict(path, device="cpu")
    assert set(outputs) == set(heads)
    for head in heads:
        assert outputs[head].shape == targets[head].shape
        assert outputs[head].shape[0] == len(test_ids)
        if head.startswith("sub-activity"):
            assert outputs[head].shape[2] == humans
    results = predict_cli.evaluate_predictions(targets, outputs, print_report=False)
    assert all(0.0 <= r["f1"] <= 1.0 for r in results.values())


def test_train_and_predict_mphoi_stage1(mphoi):
    root, _, checkpoint = mphoi
    _check_run(run_dir(root, "mphoi"), checkpoint, 2,
               ["sub-activity_recognition", "sub-activity_prediction"], 2)


def test_train_and_predict_cad120_stage1(tmp_path):
    paths = generate_cad120_dataset(str(tmp_path / "data"), num_videos=8, min_len=24,
                                    max_len=42, seed=12)
    checkpoint = train_cli.main([
        "models=2G-GCN_stage1", "data=cad120", f"data.path={paths['path']}",
        f"data.path_zarr={paths['path_zarr']}",
        f"data.video_id_to_subject_id={paths['video_id_to_subject_id']}",
        "data.cross_validation_test_subject=Subject1", *SMALL, "optimization.epochs=1",
        "parameters.gcn_node=19", "parameters.message_humans_to_human=false",
        f"logging.root_log_dir={tmp_path}/outputs/cad120/2G-GCN", "--device", "cpu"])
    _check_run(run_dir(tmp_path, "cad120", 1, subject="Subject1"), checkpoint, 1,
               ["sub-activity_recognition", "sub-activity_prediction",
                "affordance_recognition", "affordance_prediction"], 1)


def test_train_and_predict_bimanual(tmp_path):
    paths = generate_bimanual_dataset(str(tmp_path / "data"), num_videos=8, min_len=24,
                                      max_len=42, seed=13)
    checkpoint = train_cli.main([
        "models=2G-GCN_stage1", "data=bimanual",
        *(f"data.{k}={paths[k]}" for k in ("path", "path_zarr", "path_bb_zarr",
                                            "path_hp_zarr", "video_id_to_video_fps")),
        "data.cross_validation_test_subject=2", *SMALL, "optimization.epochs=1",
        "parameters.gcn_node=30", f"logging.root_log_dir={tmp_path}/outputs/bimanual/2G-GCN",
        "--device", "cpu"])
    _check_run(run_dir(tmp_path, "bimanual", 1, subject="2"), checkpoint, 1,
               ["sub-activity_recognition", "sub-activity_prediction"], 2)


def test_resume_replays_the_uninterrupted_run(mphoi, tmp_path):
    """Stop after epoch 1 (a 1-epoch run leaves last.ckpt at epoch 1), then
    resume to 2 epochs in the same run dir: the same losses and best
    weights, bit for bit, as the module's uninterrupted 2-epoch run."""
    root, paths, full = mphoi
    overrides = mphoi_overrides(paths, tmp_path)
    epochs_at = overrides.index("optimization.epochs=2")
    overrides[epochs_at] = "optimization.epochs=1"
    # The run dir's name carries the epochs: name the stopped run as the full one.
    name = RUN.format(epochs=2, threshold=0.5, subject="Subject45")
    train_cli.main(overrides + [f"logging.checkpoint_name={name}"])
    overrides[epochs_at] = "optimization.epochs=2"
    resumed = train_cli.main(overrides + ["misc.resume=true"])
    assert resumed["train_losses"] == full["train_losses"]
    assert resumed["val_losses"] == full["val_losses"]
    assert resumed["epoch"] == full["epoch"]
    flat = lambda tree: [np.asarray(x) for x in _leaves(tree)]
    for a, b in zip(flat(resumed["model_state_dict"]), flat(full["model_state_dict"])):
        np.testing.assert_array_equal(a, b)
    assert train_cli.main(overrides + ["misc.resume=true"]) == {}       # nothing left to do


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_stage2_warm_start_from_stage1_run_dir(mphoi, tmp_path, capsys):
    root, paths, _ = mphoi
    overrides = mphoi_overrides(paths, tmp_path, epochs=1, models="2G-GCN_stage2")
    checkpoint = train_cli.main(overrides + [f"misc.pretrained_path={run_dir(root, 'mphoi')}"])
    out = capsys.readouterr().out
    taken = [line for line in out.splitlines() if line.startswith("Warm-started from")]
    assert len(taken) == 1 and taken[0].endswith("parameter leaves taken"), out[-2000:]
    # The count of leaves the stage-2 init takes from the stage-1 tree.
    own = select_model("2G-GCN", device="cpu", input_size=(2152, 2048), num_classes=(13, None),
                       **compose(train_cli.CONF_DIR, overrides=overrides[:-2]).parameters
                       ).init(torch.Generator().manual_seed(train_cli.SEED))
    merged = merge_params(own, load_model_weights(run_dir(root, "mphoi")))
    assert int(taken[0].split(": ")[-1].split()[0]) == count_merged(own, merged) > 0
    assert len(checkpoint["train_losses"][0][1]) == 6
    assert os.path.exists(os.path.join(run_dir(tmp_path, "mphoi", 1, 0.1),
                                       RUN.format(epochs=1, threshold=0.1,
                                                  subject="Subject45") + ".ckpt"))


def test_predict_cross_validate_two_folds(tmp_path, capsys):
    paths = generate_mphoi_dataset(str(tmp_path / "data"), num_videos=10, min_len=24,
                                   max_len=34, seed=15,
                                   subject_pairs=("45", "25", "13", "13", "12"))
    for subject in ("Subject45", "Subject25"):
        train_cli.main(mphoi_overrides(paths, tmp_path, subject=subject, epochs=1))
    capsys.readouterr()
    predict_cli.main(["--pretrained_model_dir", run_dir(tmp_path, "mphoi", 1),
                      "--cross_validate", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "\nSubject45\n" in out and "\nSubject25\n" in out
    assert "Summary Performance for Cross-validation." in out
    assert "Summary F1@k results." in out
    # Two folds: every summary row lists two values.
    values = [line for line in out.splitlines() if line.strip().startswith("Values:")]
    assert values and all(line.count(",") == 1 for line in values)


def test_scaler_unpickler_without_sklearn(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, size=(50, 6)).astype(np.float32)
    x[::7, 2] = np.nan
    x[:, 4] = 1.5                                        # a constant feature: scale 1
    ours = StandardScaler().fit(x)
    # scikit-learn's StandardScaler as a pickle names it, with its attributes.
    module = types.ModuleType("sklearn.preprocessing._data")
    module.StandardScaler = type("StandardScaler", (), {"__module__": module.__name__})
    fake = module.StandardScaler()
    fake.__dict__.update(mean_=ours.mean_, var_=ours.var_, scale_=ours.scale_,
                         n_samples_seen_=ours.n_samples_seen_, with_mean=True, with_std=True,
                         copy=True, n_features_in_=6)
    monkeypatch.setitem(sys.modules, module.__name__, module)
    data = pickle.dumps({"scalers": {"human_scaler": fake}})
    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    for key in [k for k in sys.modules if k == "sklearn" or k.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, key)
    scaler = ScalerUnpickler(io.BytesIO(data)).load()["scalers"]["human_scaler"]
    assert type(scaler) is StandardScaler
    assert scaler.scale_[4] == 1.0
    np.testing.assert_array_equal(scaler.transform(x), ours.transform(x))
    got = scaler.transform(x)
    assert got.dtype == np.float32 and np.isnan(got[::7, 2]).all()
    np.testing.assert_allclose(np.nanmean(got[:, [0, 1, 3, 5]], axis=0), 0.0, atol=1e-5)


@pytest.mark.parametrize("change, refusal", [
    (["resources.num_devices=2"], None),
    (["resources.distributed.num_processes=2"], None),
    (["logging.checkpoint_backend=orbax"], "not ported"),
], ids=["change0-item 9", "change1-item 9", "change2-not ported"])
def test_train_cli_refuses_what_is_not_ported(change, refusal, mphoi, tmp_path):
    """The orbax backend is refused. Data parallelism over two gloo
    processes (num_devices=2), and a distributed block with no coordinator
    (one process, as in the JAX package), train and give the one-process
    run's losses (tests/test_distributed.py's tolerance)."""
    if refusal is not None:
        with pytest.raises(NotImplementedError, match=refusal):
            train_cli.main(["models=2G-GCN_stage1", "data=mphoi", *change, "--device", "cpu"])
        return
    root, paths, want = mphoi
    got = train_cli.main(mphoi_overrides(paths, tmp_path) + change)
    assert os.path.isfile(os.path.join(run_dir(tmp_path, "mphoi"), "last.ckpt"))
    for key in ("train_losses", "val_losses"):
        assert len(got[key]) == len(want[key]) == 2
        for (total_g, per_g), (total_w, per_w) in zip(got[key], want[key]):
            np.testing.assert_allclose(total_g, total_w, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(per_g, per_w, rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without CUDA")
def test_entry_points_raise_without_cuda(mphoi):
    root, paths, _ = mphoi
    overrides = mphoi_overrides(paths, root)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(overrides[:-2])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(overrides[:-1] + ["cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_cli.main(["--pretrained_model_dir", run_dir(root, "mphoi")])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_cli.predict(run_dir(root, "mphoi"))
    args = argparse.Namespace(pretrained_model_dir=run_dir(root, "mphoi"), cross_validate=False,
                              convert_frame_to_segment_level=False,
                              save_visualisations_dir=None, inspect_model=False, device="cpu")
    predict_cli.predict_all(args)
