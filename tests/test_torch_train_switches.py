"""The train CLI's two observability switches on the CPU, without JAX:
``resources.jax_profiler_dir`` and ``resources.debug_nans``, the keys of
the root ``train.py`` (``train.py:75-76,83,179-195``).

* ``python -m tggcn_torch.train ... resources.jax_profiler_dir=DIR`` (a DIR
  that does not exist yet) leaves one Chrome trace, ``DIR/trace.rank0.json``,
  that loads as JSON and holds the run's host events, the fit loop's
  train steps among them.
* ``resources.debug_nans=true`` on a clean synthetic MPHOI dataset gives
  the run without it, losses bit for bit; on a dataset with a NaN planted
  in a training clip's features it raises FloatingPointError naming the
  epoch and the step, where the run without the switch goes on with NaN
  losses, as before.
* The fit loop itself (``train/loop.py`` ``train``) on a baseline at
  hidden 6, three batches in a fixed order: a NaN in the second batch
  raises at train step 1, naming a loss; a NaN in the val set alone (at
  learning rate 0) raises at the first val eval step; the clean loop's
  losses are those of the loop without the switch, bit for bit.
* Nothing in ``resources`` is refused but the orbax backend.
"""

import json
import os

import numpy as np
import pytest
import torch

from tggcn_torch.config import compose
from tggcn_torch.data.feeders import select_model_data_fetcher
from tggcn_torch.data.loading import ArrayDataLoader
from tggcn_torch.data.synthetic import generate_mphoi_dataset
from tggcn_torch.models.registry import select_model
from tggcn_torch.train import cli as train_cli
from tggcn_torch.train.loop import first_nan, train
from tggcn_torch.train.losses import select_loss

STORES = ("path", "path_zarr", "path_obb_zarr", "path_hbb_zarr", "path_hps_zarr")


def overrides(paths, root, epochs=1, *extra):
    return ["models=2G-GCN_stage1", "data=mphoi",
            *(f"data.{k}={paths[k]}" for k in STORES),
            "data.cross_validation_test_subject=Subject45", "parameters.hidden_size=16",
            "optimization.batch_size=2", "optimization.val_fraction=0.25",
            f"optimization.epochs={epochs}", f"logging.root_log_dir={root}/outputs",
            *extra, "--device", "cpu"]


def _dataset(root, nan=False):
    paths = generate_mphoi_dataset(str(root), num_videos=8, min_len=24, max_len=42, seed=11)
    if nan:
        # The loader turns a NaN feature into 0 (nan_to_num, as the JAX
        # package and the reference do) and +inf into the largest float32,
        # whose products overflow: every feature of one training clip's
        # first human is +inf, and whichever batch holds the clip (train
        # or val) gets NaN losses.
        with np.load(paths["path_zarr"]) as f:
            stores = dict(f)
        stores["Subject12-task-take1/Human1"][:] = np.inf
        np.savez(paths["path_zarr"], **stores)
    return paths


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """A synthetic MPHOI dataset and its 1-epoch run without a switch."""
    root = tmp_path_factory.mktemp("clean")
    paths = _dataset(root / "data")
    return root, paths, train_cli.main(overrides(paths, root))


def test_profiler_dir_leaves_a_chrome_trace(clean, tmp_path):
    _, paths, _ = clean
    trace_dir = tmp_path / "trace" / "new"                        # made by the run
    train_cli.main(overrides(paths, tmp_path, 1, f"resources.jax_profiler_dir={trace_dir}"))
    assert os.listdir(trace_dir) == ["trace.rank0.json"]
    with open(trace_dir / "trace.rank0.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(trace["traceEvents"]) > 100
    assert any(n.startswith("aten::") for n in names)
    assert any("Optimizer.step" in n for n in names), sorted(names)[:20]


def test_debug_nans_keeps_a_clean_run(clean, tmp_path):
    _, paths, want = clean
    got = train_cli.main(overrides(paths, tmp_path, 1, "resources.debug_nans=true"))
    for key in ("train_losses", "val_losses"):
        assert got[key] == want[key]
    got, want = _flat(got["model_state_dict"]), _flat(want["model_state_dict"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def nan_paths(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("nan") / "data", nan=True)


def test_debug_nans_raises_at_the_first_nan_step(nan_paths, tmp_path):
    with pytest.raises(FloatingPointError,
                       match=r"debug_nans: a NaN in .+ at epoch 1, (train|val eval) step \d+"):
        train_cli.main(overrides(nan_paths, tmp_path, 1, "resources.debug_nans=true"))


def test_without_debug_nans_a_nan_trains_on(nan_paths, tmp_path):
    got = train_cli.main(overrides(nan_paths, tmp_path))
    assert len(got["train_losses"]) == 1
    assert np.isnan(got["train_losses"][-1][0])


def _baseline_batches(rng, n, t=9, objects=3, width=32):
    """A cad120_baseline batch list of n clips: 3 inputs, 2 targets."""
    y_o = rng.integers(0, 12, size=(n, t, objects)).astype(np.float32)
    return [rng.normal(size=(n, t, 1, width)).astype(np.float32),
            rng.normal(size=(n, t, objects, width)).astype(np.float32),
            np.ones((n, objects), np.float32),
            rng.integers(0, 10, size=(n, t, 1)).astype(np.float32), y_o]


def _fit(train_batch, val_batch=None, lr=1e-3, debug_nans=False):
    name = "cad120_baseline"
    model = select_model(name, device="cpu", input_size=(32, 32), num_classes=(10, 12),
                         hidden_size=6)
    criterion, names = select_loss(name, "multiple", "cad120", {})
    loader = lambda b: ArrayDataLoader(b, batch_size=2, shuffle=False)
    return train(model, loader(train_batch), lr, criterion, 1, names,
                 fetch_model_data=select_model_data_fetcher(name, "multiple"),
                 feed_model_data=lambda d: dict(zip(("x_human", "x_objects", "objects_mask"),
                                                    d)),
                 val_loader=None if val_batch is None else loader(val_batch),
                 init_params=model.init(torch.Generator().manual_seed(0)),
                 debug_nans=debug_nans)


def test_fit_loop_names_the_step_and_the_tensor():
    rng = np.random.default_rng(0)
    batches, val = _baseline_batches(rng, 6), _baseline_batches(rng, 2)
    want = _fit(batches, val)
    got = _fit(batches, val, debug_nans=True)
    assert got["train_losses"] == want["train_losses"]
    assert got["val_losses"] == want["val_losses"]
    poisoned = [x.copy() for x in batches]
    poisoned[0][2, 4, 0, 7] = np.nan                              # batch 1 of 0, 1, 2
    with pytest.raises(FloatingPointError,
                       match=r"a NaN in loss \w+ at epoch 1, train step 1 \(global step 1\)"):
        _fit(poisoned, val, debug_nans=True)
    assert np.isnan(_fit(poisoned, val)["train_losses"][0][0])
    poisoned_val = [x.copy() for x in val]
    poisoned_val[1][0, 0, 0, 0] = np.nan
    with pytest.raises(FloatingPointError, match=r"at epoch 1, val eval step 0$"):
        _fit(batches, poisoned_val, lr=0.0, debug_nans=True)


def test_first_nan_skips_infinities_and_names_the_first():
    x, nan, inf = torch.zeros(3), torch.tensor([0.0, float("nan")]), torch.tensor([float("inf")])
    assert first_nan([("x", x), ("inf", inf), ("none", None)]) is None
    assert first_nan([("x", x), ("inf", inf), ("a", nan), ("b", nan)]) == "a"


def test_train_cli_refuses_nothing_else_in_resources():
    """After the orbax backend (tests/test_torch_entry.py), no key of
    ``resources`` is refused: the switches, parity modes, devices."""
    for change in (["resources.jax_profiler_dir=/nonexistent/trace",
                    "resources.debug_nans=true", "resources.parity_mode=exact",
                    "resources.num_threads=1", "resources.use_gpu=false"],
                   ["resources.parity_mode=fast", "resources.debug_nans=false"]):
        cfg = compose(train_cli.CONF_DIR, overrides=["models=2G-GCN_stage1", "data=mphoi",
                                                     *change])
        train_cli.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        train_cli.check_supported(compose(train_cli.CONF_DIR, overrides=[
            "models=2G-GCN_stage1", "data=mphoi", "logging.checkpoint_backend=orbax"]))
