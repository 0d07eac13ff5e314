"""The baselines (CAD120Baseline, BimanualBaseline) in the port, on the CPU
and without JAX.

* Both golden fixtures (``tests/golden/baseline_*.npz``, from the
  reference's PyTorch models) at ``tests/test_golden_baselines.py``'s
  tolerance, rtol 2e-4, atol 2e-5.
* A baseline batch of 3 clips padded to a batch of 4 by the fit loop's
  batches (3 inputs, then the targets) keeps -1 in every target row of the
  pad, and its losses equal those of the 3 real clips (rtol 1e-6); a fit
  loop at learning rate 0 records those losses.
* ``python -m tggcn_torch.train`` then ``python -m tggcn_torch.predict``
  for ``cad120_baseline`` and ``bimanual_baseline`` at hidden 8 on the
  synthetic datasets, ``--device cpu``.
* A reference ``.tar`` run dir of a baseline loads through
  ``baseline_params_from_torch_state_dict`` and reproduces the fixture.
* The refusals that remain: a 2G-GCN-only registry call, the multi-task
  loss learner, an unknown model (registry, fetcher and feeder). No width
  is refused on the card: K1 and K2 run any width at the next one they
  take (``ops/widths.py``).
* On the card (``cuda`` marker): the kernel route (K1 forward, K2
  backward) against the plain route, forward and gradients.
"""

import glob
import os

import numpy as np
import pytest
import torch

from tggcn_torch import predict as predict_cli
from tggcn_torch.compat.weights import baseline_params_from_torch_state_dict
from tggcn_torch.data.feeders import (num_inputs, select_model_data_feeder,
                                     select_model_data_fetcher)
from tggcn_torch.data.loading import ArrayDataLoader
from tggcn_torch.data.synthetic import generate_bimanual_dataset, generate_cad120_dataset
from tggcn_torch.models import baselines
from tggcn_torch.models.baselines import BaselineConfig, apply_baseline, init_baseline
from tggcn_torch.models.registry import select_model, with_config_changes
from tggcn_torch.ops.widths import aligned
from tggcn_torch.train import cli as train_cli
from tggcn_torch.train.checkpoint import load_model_weights
from tggcn_torch.train.loop import device_batches, make_eval_step, train
from tggcn_torch.train.losses import select_loss, select_loss_types

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "baseline_*.npz")))
SMALL = ["parameters.hidden_size=8", "optimization.batch_size=2",
         "optimization.val_fraction=0.25", "optimization.epochs=2", "--device", "cpu"]


def read_fixture(path):
    """(inputs, weights, outputs, the fixture's BaselineConfig)."""
    data = np.load(path)
    inputs = {k.split("::")[1]: data[k] for k in data.files if k.startswith("input::")}
    weights = {k.split("::")[1]: data[k] for k in data.files if k.startswith("weight::")}
    count = len([k for k in data.files if k.startswith("output::")])
    outputs = [data[f"output::{i}"] for i in range(count)]
    cad120 = "cad120" in os.path.basename(path)
    cfg = BaselineConfig(input_size=(2124, 2048), num_classes=(10, 12) if cad120 else (14, None),
                         hidden_size=16, with_object_head=cad120)
    return inputs, weights, outputs, cfg


def _apply(params, cfg, inputs, **kw):
    return apply_baseline(params, cfg, *(torch.as_tensor(inputs[k]) for k in
                                         ("x_human", "x_objects", "objects_mask")), **kw)


@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p)[:-4] for p in FIXTURES])
def test_baseline_matches_reference(path):
    inputs, weights, want, cfg = read_fixture(path)
    got = _apply(baseline_params_from_torch_state_dict(weights), cfg, inputs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5, err_msg=f"output {i}")


def _baseline_batch(rng, n, t=9, objects=3, width=32):
    """A cad120_baseline batch list of n clips: 3 inputs, 2 targets."""
    mask = np.ones((n, objects), np.float32)
    mask[0, -1] = 0.0
    y_o = rng.integers(0, 12, size=(n, t, objects)).astype(np.float32)
    y_o[0, :, -1] = -1.0
    return [rng.normal(size=(n, t, 1, width)).astype(np.float32),
            rng.normal(size=(n, t, objects, width)).astype(np.float32), mask,
            rng.integers(0, 10, size=(n, t, 1)).astype(np.float32), y_o]


def test_padded_baseline_batch_keeps_its_targets_masked():
    name = "cad120_baseline"
    model = select_model(name, device="cpu", input_size=(32, 32), num_classes=(10, 12),
                         hidden_size=8)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _baseline_batch(np.random.default_rng(0), 3)
    loader = ArrayDataLoader(batch, batch_size=4, shuffle=False)
    (padded,) = list(device_batches(loader, 4, num_inputs(name), "cpu"))
    assert num_inputs(name) == 3 and [len(x) for x in padded] == [4] * 5
    for target in padded[3:]:
        assert bool((target[3] == -1).all())
    assert bool((padded[2][3] == 0).all())
    fetch = select_model_data_fetcher(name, "multiple")
    criterion, names = select_loss(name, "multiple", "cad120", {})
    eval_step = make_eval_step(model, lambda d: dict(zip(("x_human", "x_objects",
                                                          "objects_mask"), d)), criterion)
    real = eval_step({"model": params}, *fetch([torch.as_tensor(x) for x in batch]))[0]
    got = eval_step({"model": params}, *fetch(padded))[0]
    torch.testing.assert_close(got, real, rtol=1e-6, atol=0)
    checkpoint = train(model, loader, 0.0, criterion, 1, names,
                       fetch_model_data=fetch,
                       feed_model_data=lambda d: dict(zip(("x_human", "x_objects",
                                                           "objects_mask"), d)),
                       init_params=params)
    np.testing.assert_allclose(checkpoint["train_losses"][0][1], real.numpy(), rtol=1e-6)


def _run_dir(root, dataset, model):
    (path,) = [p for p in glob.glob(os.path.join(str(root), "outputs", dataset, model, "*"))
               if os.path.basename(p) != "runs"]
    return path


def _check_run(path, checkpoint, heads, entities):
    name = os.path.basename(path)
    for f in (".hydra/config.yaml", f"{name}.ckpt", "last.ckpt"):
        assert os.path.exists(os.path.join(path, f)), f
    assert len(checkpoint["train_losses"]) == 2
    assert all(np.isfinite(total) for total, _ in checkpoint["train_losses"])
    outputs, targets, test_ids = predict_cli.predict(path, device="cpu")
    assert sorted(outputs) == sorted(heads)
    for head, e in zip(heads, entities):
        assert outputs[head].shape == targets[head].shape
        assert outputs[head].shape[0] == len(test_ids) and outputs[head].shape[2] == e


def test_train_and_predict_cad120_baseline(tmp_path):
    paths = generate_cad120_dataset(str(tmp_path / "data"), num_videos=8, min_len=24,
                                    max_len=42, seed=12)
    checkpoint = train_cli.main([
        "models=cad120_baseline", "data=cad120", f"data.path={paths['path']}",
        f"data.path_zarr={paths['path_zarr']}",
        f"data.video_id_to_subject_id={paths['video_id_to_subject_id']}",
        "data.cross_validation_test_subject=Subject1", *SMALL,
        f"logging.root_log_dir={tmp_path}/outputs/cad120/cad120_baseline"])
    assert [len(raw) for _, raw in checkpoint["train_losses"]] == [2, 2]
    _check_run(_run_dir(tmp_path, "cad120", "cad120_baseline"), checkpoint,
               ["sub-activity_recognition", "affordance_recognition"], [1, 3])


def test_train_and_predict_bimanual_baseline(tmp_path):
    paths = generate_bimanual_dataset(str(tmp_path / "data"), num_videos=8, min_len=24,
                                      max_len=42, seed=13)
    checkpoint = train_cli.main([
        "models=bimanual_baseline", "data=bimanual",
        *(f"data.{k}={paths[k]}" for k in ("path", "path_zarr", "path_bb_zarr",
                                            "path_hp_zarr", "video_id_to_video_fps")),
        "data.cross_validation_test_subject=2", *SMALL,
        f"logging.root_log_dir={tmp_path}/outputs/bimanual/bimanual_baseline"])
    assert [len(raw) for _, raw in checkpoint["train_losses"]] == [1, 1]
    _check_run(_run_dir(tmp_path, "bimanual", "bimanual_baseline"), checkpoint,
               ["sub-activity_recognition"], [2])


@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p)[:-4] for p in FIXTURES])
def test_reference_tar_of_a_baseline_loads(path, tmp_path):
    """A reference run dir holds ``<name>/<name>.tar`` with the torch state
    dict: it loads for the baseline's config (and for None, as JAX passes)."""
    inputs, weights, want, cfg = read_fixture(path)
    run = tmp_path / "hs16_reference"
    run.mkdir()
    torch.save({"model_state_dict": {k: torch.as_tensor(v) for k, v in weights.items()}},
               run / "hs16_reference.tar")
    for given in (cfg, None):
        params = load_model_weights(str(run), cfg=given)
        got = _apply(params, cfg, inputs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5)


def test_what_the_baselines_refuse():
    cfg = BaselineConfig(input_size=(8, 8), num_classes=(3, None), hidden_size=6)
    # The card no longer refuses a width: K1 and K2 run width 6 at 8, the
    # padded units zero (ops/widths.py; the card's cases in test_torch_cuda.py).
    assert not hasattr(baselines, "check_width")
    assert aligned(cfg.hidden_size, torch.float32) == 8
    model = select_model("bimanual_baseline", device="cpu", input_size=(8, 8),
                         num_classes=(3, None), hidden_size=6, compute_dtype="bfloat16")
    assert model.config == cfg                    # compute_dtype is dropped, as in JAX
    with pytest.raises(ValueError, match="only supports 2G-GCN"):
        with_config_changes(model, hidden_size=8)
    with pytest.raises(ValueError, match="not implemented"):
        select_loss_types("bimanual_baseline", "bimanual")
    with pytest.raises(ValueError, match="Unknown model"):
        select_model("lstm", device="cpu")
    for select in (select_model_data_fetcher, select_model_data_feeder):
        with pytest.raises(KeyError, match="lstm"):
            select("lstm", "multiple")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [True, False])
def test_kernel_route_matches_plain_route(cuda, bidirectional):
    """K1 and K2 against their plain versions on the card, both baselines'
    streams in one launch: outputs within 1e-5, gradients within 1e-4 of
    each leaf's largest."""
    from tggcn_torch.models.registry import to_device
    from tggcn_torch.train.loop import model_parameters

    path = [p for p in FIXTURES if "cad120" in p][0]
    inputs, _, _, cfg = read_fixture(path)
    cfg = BaselineConfig(**{**cfg.__dict__, "bidirectional": bidirectional})
    params = to_device(init_baseline(torch.Generator().manual_seed(0), cfg), cuda)
    x = {k: torch.as_tensor(v, device=cuda) for k, v in inputs.items()}
    runs = []
    for use_kernels in (True, False):
        for p in model_parameters(params):
            p.grad = None
            p.requires_grad_(True)
        out = apply_baseline(params, cfg, x["x_human"], x["x_objects"], x["objects_mask"],
                             use_kernels=use_kernels)
        sum(o.square().mean() for o in out).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()     # 'bwd' unused
                 for p in model_parameters(params)]
        runs.append(([o.detach() for o in out], grads))
    (got, got_g), (ref, ref_g) = runs
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    for g, r in zip(got_g, ref_g):
        assert float((g - r).abs().max()) <= 1e-4 * max(float(r.abs().max()), 1e-12)
