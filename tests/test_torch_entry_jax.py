"""The port's entry layer against the JAX package on the CPU: configs, data
loading, metrics, the engine's label transforms, run dirs read across the
two packages, and one end-to-end predict.

* ``compose`` equals ``tggcn.config.compose`` for every models x data pair
  of ``conf/`` and a set of overrides, and ``load_config`` reads a frozen
  config back the same.
* The synthetic datasets of both packages write the same arrays from a
  seed; the loaders give the same train and val batches, in the same order
  (epoch 1 and 2), the same test batches, test ids, segmentations and data
  info, and the same fitted scalers (the port's numpy StandardScaler
  against scikit-learn's), bit for bit, for every dataset from .npz
  stores, and for MPHOI from zarr stores: uncompressed, zlib and blosc
  (blosc needs native/libbloscdec.so; without it both packages raise the
  same error).
* ``evaluate_predictions`` (micro and macro P/R/F1, scikit-learn in the
  JAX package) within 1e-12 and ``evaluate_f1_at_k`` equal, on random
  padded labels.
* The engine's ``upsample_predictions``, ``undouble_15fps_rows`` and
  ``segment_level_summary`` equal.
* A run dir written by the JAX package (its init, ``save_checkpoint`` and
  ``save_config``) is read by the port, and one written by the port's
  train CLI is read by the JAX package's ``RunDir`` and
  ``load_model_weights``: equal parameter trees and configs (a JAX run's
  ``last.ckpt``, which holds optax's state, is refused); merged into a
  stage-2 init, it gives the leaves JAX's ``merge_params`` takes. A reference
  ``.tar`` built from the golden fixture's ``weight::`` block gives equal
  trees through both packages' loaders.
* End to end: the port's train CLI writes an MPHOI stage-1 run dir (hidden
  16, 'st' decisions, so no Gumbel draw enters), and the JAX package's
  ``predict.predict`` and the port's give equal labels, targets and test
  ids on it. That is the one JAX forward this file compiles (T <= 14, the
  JAX package's default XLA routing).
"""

import builtins
import os
import pathlib
import pickle
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

import tggcn.config as jax_config
import tggcn.data.loading as jax_loading
import tggcn.data.synthetic as jax_synthetic
import tggcn.eval.engine as jax_engine
import tggcn.eval.reporting as jax_reporting
from tggcn.eval.rundir import RunDir as JaxRunDir
from tggcn.models.tggcn import TGGCNConfig as JaxTGGCNConfig
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn.train import checkpoint as jax_checkpoint
from tggcn_torch import config as port_config
from tggcn_torch import predict as port_predict
from tggcn_torch.compat.weights import params_to_numpy
from tggcn_torch.data import loading as port_loading
from tggcn_torch.data import synthetic as port_synthetic
from tggcn_torch.data import zarr_lite
from tggcn_torch.eval import engine as port_engine
from tggcn_torch.eval import reporting as port_reporting
from tggcn_torch.eval.rundir import RunDir as PortRunDir
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig
from tggcn_torch.train import checkpoint as port_checkpoint
from tggcn_torch.train import cli as train_cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = str(ROOT / "conf")
sys.path.insert(0, str(ROOT))
MODELS = sorted(p.stem for p in (ROOT / "conf" / "models").glob("*.yaml"))
DATA = sorted(p.stem for p in (ROOT / "conf" / "data").glob("*.yaml"))
OVERRIDES = ["parameters.hidden_size=16", "optimization.learning_rate=1e-3",
             "data.cross_validation_test_subject=Subject14", "misc.resume=true",
             "logging.root_log_dir=/tmp/x/${data.name}", "parameters.update_segment_threshold=0.25",
             "misc.segmentation_loss.sigma=2", "resources.num_devices=1", "optimization.epochs=3"]
GENERATORS = {"mphoi": "generate_mphoi_dataset", "cad120": "generate_cad120_dataset",
              "bimanual": "generate_bimanual_dataset"}
TEST_SUBJECT = {"mphoi": "Subject45", "cad120": "Subject1", "bimanual": 2}


def _tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _tree_leaves(tree[key],
                                                                      f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _tree_leaves(sub, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _tree_leaves(got), _tree_leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("models", MODELS)
@pytest.mark.parametrize("data", DATA)
def test_compose_matches_jax(models, data, monkeypatch):
    monkeypatch.setenv("PWD", "/data/root")
    for overrides in ([f"models={models}", f"data={data}"],
                      [f"models={models}", f"data={data}", *OVERRIDES]):
        want = jax_config.compose(CONF, overrides=overrides)
        got = port_config.compose(CONF, overrides=overrides)
        assert got.to_dict() == want.to_dict()
        assert got.logging.checkpoint_name == want.logging.checkpoint_name


def test_frozen_config_round_trip(tmp_path):
    cfg = port_config.compose(CONF, overrides=["data=cad120", *OVERRIDES])
    port_config.save_config(cfg, str(tmp_path / "a" / "config.yaml"))
    jax_config.save_config(jax_config.compose(CONF, overrides=["data=cad120", *OVERRIDES]),
                           str(tmp_path / "b" / "config.yaml"))
    assert ((tmp_path / "a" / "config.yaml").read_text()
            == (tmp_path / "b" / "config.yaml").read_text())
    assert (port_config.load_config(str(tmp_path / "a" / "config.yaml")).to_dict()
            == jax_config.load_config(str(tmp_path / "b" / "config.yaml")).to_dict())


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _recompress(store: str, codec: str) -> None:
    """Rewrite every chunk of a zarr-v2 store (written uncompressed) with
    zlib or blosc-lz4 (the system's c-blosc, as zarr writes it)."""
    import json

    if codec == "blosc":
        from test_zarr import _real_blosc_compress
    for meta_path in pathlib.Path(store).rglob(".zarray"):
        meta = json.loads(meta_path.read_text())
        itemsize = np.dtype(meta["dtype"]).itemsize
        for chunk in meta_path.parent.iterdir():
            if chunk.name.startswith("."):
                continue
            raw = chunk.read_bytes()
            chunk.write_bytes(zlib.compress(raw, 1) if codec == "zlib" else
                              _real_blosc_compress(raw, itemsize, 5, 1))
        meta["compressor"] = ({"id": "zlib", "level": 1} if codec == "zlib" else
                              {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                               "blocksize": 0})
        meta_path.write_text(json.dumps(meta))


def _dataset(tmp_path, name, store_format="npz", codec=None):
    kwargs = dict(num_videos=8, min_len=24, max_len=42, seed=5, store_format=store_format)
    paths = getattr(port_synthetic, GENERATORS[name])(str(tmp_path / "port"), **kwargs)
    want = getattr(jax_synthetic, GENERATORS[name])(str(tmp_path / "jax"), **kwargs)
    for key, path in paths.items():
        if key == "name" or not (path.endswith(".npz") or path.endswith(".zarr")):
            continue
        a, b = (port_loading.open_store(p) for p in (path, want[key]))
        for vid_key in np.load(path).files if path.endswith(".npz") else []:
            np.testing.assert_array_equal(a[vid_key][:], b[vid_key][:])
        if codec:
            _recompress(path, codec)
    return {"name": name, **{k: v for k, v in paths.items() if k != "name"},
            "cross_validation_test_subject": TEST_SUBJECT[name],
            "scaling_strategy": "standard", "downsampling": 3}


def _assert_batches_equal(got_loader, want_loader, epochs=(1, 2)):
    assert len(got_loader) == len(want_loader)
    assert got_loader.num_examples == want_loader.num_examples
    for epoch in epochs:
        for loader in (got_loader, want_loader):
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
        for got, want in zip(got_loader, want_loader):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def _assert_scalers_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        for attr in ("mean_", "var_", "scale_"):
            np.testing.assert_array_equal(getattr(got[key], attr), getattr(want[key], attr))


def _blosc_native():
    return os.path.exists(zarr_lite._LIB_PATH)


LOADER_CASES = [("mphoi", "npz", None), ("cad120", "npz", None), ("bimanual", "npz", None),
                ("mphoi", "zarr", None), ("mphoi", "zarr", "zlib"), ("mphoi", "zarr", "blosc")]


@pytest.mark.parametrize("name,store_format,codec", LOADER_CASES)
def test_loaders_match_jax(tmp_path, name, store_format, codec):
    data = _dataset(tmp_path, name, store_format, codec)
    if codec == "blosc" and not _blosc_native():
        # Without native/libbloscdec.so both packages refuse a blosc chunk alike.
        for loading in (port_loading, jax_loading):
            with pytest.raises(RuntimeError, match="libbloscdec.so is not built"):
                loading.load_training_data(jax_config.Config(data), "2G-GCN", "multiple")
        return
    got = port_loading.load_training_data(port_config.Config(data), "2G-GCN", "multiple",
                                          batch_size=3, val_fraction=0.25, seed=42)
    want = jax_loading.load_training_data(jax_config.Config(data), "2G-GCN", "multiple",
                                          batch_size=3, val_fraction=0.25, seed=42)
    _assert_batches_equal(got[0], want[0])
    _assert_batches_equal(got[1], want[1], epochs=(1,))
    assert got[2] == want[2]
    _assert_scalers_equal(got[3], want[3])
    test_got = port_loading.load_testing_data(port_config.Config(data), "2G-GCN", "multiple",
                                              batch_size=2, scalers=got[3])
    test_want = jax_loading.load_testing_data(jax_config.Config(data), "2G-GCN", "multiple",
                                              batch_size=2, scalers=want[3])
    _assert_batches_equal(test_got[0], test_want[0], epochs=(0,))
    assert test_got[1:] == test_want[1:]
    assert (port_loading.determine_num_classes("2G-GCN", "multiple", name)
            == jax_loading.determine_num_classes("2G-GCN", "multiple", name))


def test_bucketed_loader_matches_jax(tmp_path):
    data = dict(_dataset(tmp_path, "mphoi"), length_buckets=2, scaling_strategy=None)
    got = port_loading.load_training_data(port_config.Config(data), "2G-GCN", "multiple",
                                          batch_size=2, val_fraction=0.25)
    want = jax_loading.load_training_data(jax_config.Config(data), "2G-GCN", "multiple",
                                          batch_size=2, val_fraction=0.25)
    assert type(got[0]).__name__ == type(want[0]).__name__ == "BucketedDataLoader"
    _assert_batches_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# Metrics and the engine's transforms
# ---------------------------------------------------------------------------


def _labels(rng, shape, classes, pad_rows):
    y = rng.integers(0, classes, size=shape)
    for i, n in enumerate(pad_rows):
        y[i, y.shape[1] - n:] = -1
    return y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    # A model that is right 40% of the time, with runs; a class absent from
    # the targets and one never predicted.
    targets = {"sub-activity_recognition": _labels(rng, (5, 60, 2), 9, [0, 7, 20, 0, 59]),
               "affordance_recognition": _labels(rng, (5, 60, 3), 6, [3, 0, 0, 11, 1])}
    outputs = {}
    for head, y in targets.items():
        right = rng.uniform(size=y.shape) < 0.4
        guess = np.repeat(rng.integers(0, y.max() + 2, size=y.shape[:2] + (1,)), y.shape[2], 2)
        outputs[head] = np.where(right, np.maximum(y, 0), guess)
    names = dict(subactivity_names=[f"s{i}" for i in range(10)],
                 affordance_names=[f"a{i}" for i in range(7)])
    got = port_reporting.evaluate_predictions(targets, outputs, **names)
    want = jax_reporting.evaluate_predictions(targets, outputs, **names)
    assert sorted(got) == sorted(want)
    for key in want:
        for metric in ("precision", "recall", "f1"):
            assert abs(got[key][metric] - float(want[key][metric])) <= 1e-12, (key, metric)
    for overlap in port_reporting.OVERLAPS:
        assert (port_reporting.evaluate_f1_at_k(targets, outputs, 10, 7, overlap=overlap)
                == jax_reporting.evaluate_f1_at_k(targets, outputs, 10, 7, overlap=overlap))


def test_engine_transforms_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5, 11, 2)).astype(np.float32)
    for length in (30, 33, 36):
        np.testing.assert_array_equal(port_engine.upsample_predictions(logits, 3, length),
                                      jax_engine.upsample_predictions(logits, 3, length))
    labels = _labels(rng, (4, 20, 2), 5, [0, 4, 0, 9])
    for rows in ([], [1], [0, 2]):
        np.testing.assert_array_equal(
            port_engine.undouble_15fps_rows(labels, rows, -1, time_axis=1),
            jax_engine.undouble_15fps_rows(labels, rows, -1, time_axis=1))
        np.testing.assert_array_equal(
            port_engine.undouble_15fps_rows(logits, rows, -100.0, time_axis=2),
            jax_engine.undouble_15fps_rows(logits, rows, -100.0, time_axis=2))
    starts = [np.array([0, 4, 9]), np.array([0, 2]), np.array([0, 1, 5, 8, 10])]
    np.testing.assert_array_equal(port_engine.segment_level_summary(logits, starts, 2),
                                  jax_engine.segment_level_summary(logits, starts, 2))
    np.testing.assert_array_equal(port_engine.segment_level_summary(labels[:3], starts, 1),
                                  jax_engine.segment_level_summary(labels[:3], starts, 1))
    assert (port_engine.head_names("2G-GCN", "multiple", "cad120")
            == jax_engine.head_names("2G-GCN", "multiple", "cad120"))


# ---------------------------------------------------------------------------
# Run dirs across the two packages
# ---------------------------------------------------------------------------


def _mphoi_overrides(paths, root, epochs=1):
    return ["models=2G-GCN_stage1", "data=mphoi",
            *(f"data.{k}={paths[k]}" for k in ("path", "path_zarr", "path_obb_zarr",
                                                 "path_hbb_zarr", "path_hps_zarr")),
            "data.cross_validation_test_subject=Subject45", "parameters.hidden_size=16",
            "parameters.discrete_optimization_strategy=st", "optimization.batch_size=2",
            "optimization.val_fraction=0.25", f"optimization.epochs={epochs}",
            f"logging.root_log_dir={root}/outputs/mphoi/2G-GCN"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """An MPHOI stage-1 run dir written by the port's train CLI on the CPU."""
    root = tmp_path_factory.mktemp("port_run")
    paths = port_synthetic.generate_mphoi_dataset(str(root / "data"), num_videos=8,
                                                  min_len=24, max_len=42, seed=21)
    train_cli.main(_mphoi_overrides(paths, root) + ["--device", "cpu"])
    return os.path.join(str(root), "outputs", "mphoi", "2G-GCN",
                        "hs16_e1_bs2_lr0.0001_0.5_Subject45")


def test_port_run_dir_read_by_jax(port_run):
    want = port_checkpoint.load_model_weights(port_run)
    got = jax_checkpoint.load_model_weights(port_run)
    _assert_trees_equal(got, params_to_numpy(want))
    jax_run, run = JaxRunDir(port_run), PortRunDir(port_run)
    assert jax_run.cfg.to_dict() == run.cfg.to_dict()
    assert jax_run.load_scalers() == run.load_scalers() == {}
    assert jax_run.sibling_fold_paths() == run.sibling_fold_paths()
    assert jax_run.class_dictionaries() == run.class_dictionaries()


def test_jax_run_dir_read_by_port(tmp_path):
    cfg = jax_config.compose(CONF, overrides=["parameters.hidden_size=16",
                                              f"logging.root_log_dir={tmp_path}"])
    model_cfg = JaxTGGCNConfig.from_kwargs(input_size=(2152, 2048), num_classes=(13, None),
                                           **cfg.parameters)
    params = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(3), model_cfg))
    log_dir = cfg.logging.log_dir
    jax_config.save_config(cfg, os.path.join(log_dir, ".hydra", "config.yaml"))
    jax_checkpoint.save_checkpoint(log_dir, {"epoch": 2, "model_state_dict": params,
                                             "train_losses": [[1.0, [1.0]]], "scalers": {}},
                                   checkpoint_name=cfg.logging.checkpoint_name)
    got = port_checkpoint.load_model_weights(log_dir)
    _assert_trees_equal(params_to_numpy(got), params)
    run = PortRunDir(log_dir)
    assert run.cfg.to_dict() == JaxRunDir(log_dir).cfg.to_dict()
    assert port_checkpoint.load_run_checkpoint(log_dir)["epoch"] == 2
    # A JAX run's last.ckpt holds optax's state: the port refuses it.
    import optax

    jax_checkpoint.save_last(log_dir, {"epoch": 2, "trainable": {"model": params},
                                       "opt_state": optax.adam(1e-4).init(params)})
    with pytest.raises(pickle.UnpicklingError, match="optax"):
        port_checkpoint.load_last(log_dir)


def test_stage2_warm_start_merges_as_jax(port_run):
    """The stage-1 run dir merged into a stage-2 init: the port takes the
    leaves JAX's merge_params takes, with the same values."""
    cfg = jax_config.compose(CONF, overrides=["models=2G-GCN_stage2",
                                              "parameters.hidden_size=16"])
    kwargs = dict(input_size=(2152, 2048), num_classes=(13, None), **cfg.parameters)
    loaded = jax_checkpoint.load_model_weights(port_run)
    jax_own = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(42),
                                                          JaxTGGCNConfig.from_kwargs(**kwargs)))
    jax_merged = jax_checkpoint.merge_params(jax_own, loaded)
    from_loaded = _tree_leaves(loaded)
    taken = {k for k, v in _tree_leaves(jax_merged).items() if v is from_loaded.get(k)}
    own = select_model("2G-GCN", device="cpu", **kwargs).init(torch.Generator().manual_seed(42))
    merged = port_checkpoint.merge_params(own, port_checkpoint.load_model_weights(port_run))
    assert port_checkpoint.count_merged(own, merged) == len(taken) > 0
    got = _tree_leaves(params_to_numpy(merged))
    for key in taken:
        np.testing.assert_array_equal(got[key], _tree_leaves(jax_merged)[key], err_msg=key)


def _hide_sklearn(monkeypatch):
    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    for key in [k for k in sys.modules if k == "sklearn" or k.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, key)


def test_reference_tar_through_both_loaders(tmp_path, monkeypatch):
    from sklearn.preprocessing import StandardScaler as SklearnScaler

    data = np.load(ROOT / "tests" / "golden" / "mphoi_st.npz")
    state_dict = {k.split("::")[1]: torch.from_numpy(data[k])
                  for k in data.files if k.startswith("weight::")}
    run = tmp_path / "run_Subject45"
    run.mkdir()
    x = np.random.default_rng(0).normal(3.0, 2.0, size=(40, 5)).astype(np.float32)
    scaler = SklearnScaler().fit(x)
    torch.save({"model_state_dict": state_dict, "epoch": 7,
                "scalers": {"human_scaler": scaler}}, run / "run_Subject45.tar")
    kwargs = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=24,
                  gcn_node=26, message_humans_to_human=True, message_segment=True,
                  message_type="v2", message_granularity="v1", message_aggregation="att",
                  attention_style="v3", discrete_optimization_strategy="st",
                  object_segment_update_strategy="ind")
    want = jax_checkpoint.load_model_weights(str(run), cfg=JaxTGGCNConfig(**kwargs))
    # The card has no scikit-learn: the port reads the .tar's scikit-learn
    # scaler as its own.
    _hide_sklearn(monkeypatch)
    got = port_checkpoint.load_model_weights(str(run), cfg=TGGCNConfig.from_kwargs(**kwargs))
    _assert_trees_equal(params_to_numpy(got), jax.tree_util.tree_map(np.asarray, want))
    checkpoint = port_checkpoint.load_run_checkpoint(str(run))
    assert checkpoint["epoch"] == 7
    loaded = checkpoint["scalers"]["human_scaler"]
    assert type(loaded) is port_loading.StandardScaler
    np.testing.assert_array_equal(loaded.transform(x), scaler.transform(x))


def test_predict_matches_jax_end_to_end(port_run):
    import predict as jax_predict

    want = jax_predict.predict(port_run)
    got = port_predict.predict(port_run, device="cpu")
    outputs, targets, test_ids = got
    assert test_ids == want[2]
    assert sorted(outputs) == sorted(want[0]) == sorted(targets)
    for head in want[0]:
        np.testing.assert_array_equal(targets[head], want[1][head])
        assert outputs[head].shape == want[0][head].shape
        np.testing.assert_array_equal(outputs[head], want[0][head], err_msg=head)
