"""The port's training path against the JAX reference on the CPU.

* Whole-model gradients: the port's apply (train=True) and loss bundle
  against jax.grad of tggcn's apply_tggcn + select_loss at hidden 16, for
  'st' decisions and for 'gs' decisions with the Gumbel noise JAX drew
  passed in. Tolerance rtol 1e-3, atol 1e-5 per leaf: the gradient runs back
  through both recurrences (frame BiGRU, segment scan) and their float32
  rounding adds up over the sequence and the two levels.
* One make_train_step step (Adam, clipping, MTLL, BatchNorm write-back)
  against JAX's make_train_step: losses rtol 1e-5, atol 1e-6; weights,
  MTLL log-sigmas and BatchNorm state atol 1e-5, a hundredth of the learning
  rate: Adam's first step moves each weight by lr g / (|g| + eps), so where
  a gradient is small its float32 rounding shows in the step's size.
* The reference training fixtures tests/golden/training_train_mphoi_{st,
  mtll,long18}.npz through the port's own state-dict loader, at the
  tolerances tests/test_golden_training.py holds the JAX package to.
* Whole-model gradients in bfloat16 (compute_dtype, as bench.py trains):
  the port's against jax.value_and_grad of JAX's bfloat16 apply_tggcn with
  use_pallas_gru and use_pallas_segment_scan (the Pallas kernels in
  interpret mode, patched in as tests/test_gru_pallas.py and
  tests/test_segment_scan_pallas.py do), 'gs' decisions with the bfloat16
  Gumbel draws JAX made passed in: the loss within rtol 1e-3 (measured
  4.6e-4), each leaf within 3e-2 of its largest value (measured 2.3e-2; the
  port's bfloat16 against its float32 differs by 0.2 of a leaf's largest
  with 'st' decisions), float32 gradients for the float32 masters.
* A bfloat16 train step against the float32 step from the same weights:
  masters, Adam's moments and the BatchNorm state stay float32; losses
  within rtol 0.05 (tests/test_bf16.py's bound); each weight moved the
  same way as in float32 where the float32 gradient is at least a quarter
  of its leaf's largest (Adam's first step moves a weight by lr against
  the sign of its gradient; the largest float32 gradient whose sign
  bfloat16 flips here is 0.11 of its leaf's largest).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tggcn.config import Config
import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
from tggcn.data.loading import select_model_data_feeder as jax_feeder
from tggcn.models import select_model as jax_select_model
from tggcn.train.loop import make_train_step as jax_make_train_step
from tggcn.train.losses import select_loss as jax_select_loss
from tggcn.train.multi_task import init_mtll as jax_init_mtll
from tggcn_torch.compat.weights import (params_from_numpy, params_to_numpy,
                                        tggcn_params_from_torch_state_dict)
from tggcn_torch.data.feeders import (pad_batch, select_model_data_feeder,
                                      select_model_data_fetcher)
from tggcn_torch.models.registry import select_model
from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
from tggcn_torch.train.losses import (select_loss, select_loss_learning_mask,
                                      select_loss_types)
from tggcn_torch.train.multi_task import init_mtll

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "training_train_mphoi_*.npz")))
IN_SLICE = ("training_train_mphoi_st", "training_train_mphoi_mtll",
            "training_train_mphoi_long18")
FIXTURES = [p for p in FIXTURES if os.path.basename(p)[:-4] in IN_SLICE]

STAGE1 = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=16,
              gcn_node=26, message_segment=True, message_type="v2",
              message_granularity="v1", message_aggregation="att",
              attention_style="v3", object_segment_update_strategy="ind")
MISC = {"budget_loss": {"add": True, "human_weight": 0.5},
        "segmentation_loss": {"add": True, "weight": 0.8},
        "first_level_loss_weight": 0.3, "anticipation_loss_weight": 0.7}


def _batch(seed, b=2, t=6, nh=2, no=3):
    """The 2G-GCN batch list: 8 inputs, then the six MPHOI targets with some
    entries missing (-1)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, no), np.float32)
    mask[0, -1] = 0.0
    mask[1, 1:] = 0.0
    dummy = np.zeros((b, 1, 1, 1), np.float32)
    y_seg = rng.integers(0, 2, size=(b, t, nh)).astype(np.float32)
    y_rec = rng.integers(0, 13, size=(b, t, nh)).astype(np.float32)
    y_rec[1, -2:] = -1
    return [rng.normal(size=(b, t, nh, 2152)).astype(np.float32),
            rng.normal(size=(b, t, no, 2048)).astype(np.float32), mask,
            np.ones((b, t, nh), np.float32), dummy, dummy, dummy,
            np.full((b,), float(t), np.float32),
            y_seg, y_seg, y_rec, y_rec, y_rec, y_rec]


def _jax_noise(rng, b, t, nh, no, dtype=jnp.float32):
    """The Gumbel draws JAX's apply_tggcn makes from `rng` (tggcn.models.tggcn:467)
    in the decision dtype (tggcn/nn/distributions.py:42), as float32 arrays."""
    rng_h, rng_o = jax.random.split(rng)
    return {"human": np.array(jax.random.gumbel(rng_h, (b, t, nh, 2), dtype), np.float32),
            "object": np.array(jax.random.gumbel(rng_o, (b, t, no, 2), dtype), np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_tensors(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat_tensors(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("strategy", ["st", "gs"])
def test_model_gradients_match_jax(strategy):
    kwargs = dict(STAGE1, discrete_optimization_strategy=strategy)
    jax_model = jax_select_model("2G-GCN", **kwargs)
    jax_params = jax_model.init(jax.random.PRNGKey(1))
    data, targets = _batch(seed=2)[:8], _batch(seed=2)[8:]
    feeder_kwargs = dict(dataset_name="mphoi")
    jax_kwargs = jax_feeder("2G-GCN", "multiple", **feeder_kwargs)(data)
    jax_criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": MISC}))
    rng = jax.random.PRNGKey(3)

    def jax_loss(p):
        out, aux = jax_model.apply(p, train=True, rng=rng, **jax_kwargs)
        return sum(jax_criterion(out, targets)), out

    (want_total, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_params)

    model = select_model("2G-GCN", device="cpu", **kwargs)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    for p in model_parameters(params):
        p.requires_grad_(True)
    noise = _jax_noise(rng, 2, 6, 2, 3) if strategy == "gs" else None
    out, _ = model.apply(params, train=True, noise=noise,
                         **select_model_data_feeder("2G-GCN", "multiple", **feeder_kwargs)(data))
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(want_out[0]))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    total = sum(criterion(out, [torch.tensor(y) for y in targets]))
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    total.backward()
    got = {k: np.zeros_like(v) for k, v in _flat(params_to_numpy(params)).items()}
    for k, leaf in _flat_tensors(params).items():
        if leaf.grad is not None:
            got[k] = leaf.grad.numpy()
    want = _flat(want_grads)
    assert sorted(got) == sorted(want)
    for k in want:
        if "/bn/state/" in k:
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_train_step_matches_jax():
    """One step with 'gs' decisions (JAX's noise passed in), clipping at a
    norm the gradient exceeds, MTLL and the BatchNorm write-back."""
    kwargs = dict(STAGE1, discrete_optimization_strategy="gs")
    misc = dict(MISC, multi_task_loss_learner=True)
    batch = _batch(seed=4)
    data, targets = batch[:8], batch[8:]
    feeder_kwargs = dict(dataset_name="mphoi")
    lr, clip = 1e-3, 0.5
    rng = jax.random.PRNGKey(5)

    jax_model = jax_select_model("2G-GCN", **kwargs)
    jax_params = jax_model.init(jax.random.PRNGKey(6))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    jax_criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": misc}))
    jax_mtll = jax_init_mtll(["budget", "bce"] + ["softmax"] * 4, [False] * 2 + [True] * 4)
    optimizer = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    jax_step = jax_make_train_step(jax_model, jax_feeder("2G-GCN", "multiple", **feeder_kwargs),
                                   jax_criterion, optimizer, clip_gradient_at=clip,
                                   mtll=jax_mtll)
    trainable = {"model": jax_params, "mtll": jax_mtll["log_sds"]}
    trainable, _, want_losses, want_raw = jax_step(trainable, optimizer.init(trainable), rng,
                                                   data, targets)

    model = select_model("2G-GCN", device="cpu", **kwargs)
    mtll = init_mtll(select_loss_types("2G-GCN", "mphoi"),
                     select_loss_learning_mask("2G-GCN", "mphoi"))
    port = {"model": params, "mtll": mtll["log_sds"]}
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", misc)
    opt = torch.optim.Adam(trainable_parameters(port), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **feeder_kwargs),
                           criterion, opt, clip_gradient_at=clip, mtll=mtll)
    losses, raw, aux = step(port, data, targets, noise=_jax_noise(rng, 2, 6, 2, 3))
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), rtol=1e-5, atol=1e-6)
    got, want = _flat(params_to_numpy(port["model"])), _flat(trainable["model"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(port["mtll"].detach().numpy(), np.asarray(trainable["mtll"]),
                               rtol=0, atol=1e-5)
    # The BatchNorm state moved (to the batch statistics) and Adam did not touch it.
    assert not np.allclose(got["/geometry_embedding_gcn/bn/state/var"], 1.0)
    assert port["model"]["geometry_embedding_gcn"]["bn"]["state"]["mean"].grad is None


def test_bf16_model_gradients_match_jax(monkeypatch):
    """The main path's bfloat16 gradients ('gs' decisions, as stage 1 and
    bench.py train) against JAX's bfloat16 kernel route."""
    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    monkeypatch.setattr(gru_pallas, "run_multi_bigru_pallas",
                        lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(scan_pallas, "run_segment_scan_pallas",
                        lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    kwargs = dict(STAGE1, discrete_optimization_strategy="gs", compute_dtype="bfloat16")
    jax_model = jax_select_model("2G-GCN", use_pallas_gru=True, use_pallas_segment_scan=True,
                                 **kwargs)
    jax_params = jax_model.init(jax.random.PRNGKey(1))
    data, targets = _batch(seed=2)[:8], _batch(seed=2)[8:]
    feeder_kwargs = dict(dataset_name="mphoi")
    jax_kwargs = jax_feeder("2G-GCN", "multiple", **feeder_kwargs)(data)
    jax_criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": MISC}))
    rng = jax.random.PRNGKey(3)

    def jax_loss(p):
        out, aux = jax_model.apply(p, train=True, rng=rng, **jax_kwargs)
        return sum(jax_criterion(out, targets)), out

    (want_total, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_params)

    model = select_model("2G-GCN", device="cpu", **kwargs)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    for p in model_parameters(params):
        p.requires_grad_(True)
    out, _ = model.apply(params, train=True, noise=_jax_noise(rng, 2, 6, 2, 3, jnp.bfloat16),
                         **select_model_data_feeder("2G-GCN", "multiple", **feeder_kwargs)(data))
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(want_out[0]))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    total = sum(criterion(out, [torch.tensor(y) for y in targets]))
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-3)
    total.backward()
    got = {k: leaf.grad for k, leaf in _flat_tensors(params).items() if leaf.grad is not None}
    assert all(g.dtype == torch.float32 for g in got.values())
    want = {k: v for k, v in _flat(want_grads).items() if "/bn/state/" not in k}
    # A leaf whose gradient is rounding noise (the GeoGCN s2 bias's is 0 in
    # exact arithmetic, 1e-12 here) is held to a millionth of the largest.
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        assert np.abs(g - w).max() <= 3e-2 * max(float(np.abs(w).max()), floor), k


def test_bf16_train_step_keeps_float32_state():
    kwargs = dict(STAGE1, discrete_optimization_strategy="gs")
    batch = _batch(seed=9)
    data, targets = batch[:8], batch[8:]
    feeder = select_model_data_feeder("2G-GCN", "multiple", dataset_name="mphoi")
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    noise = _jax_noise(jax.random.PRNGKey(10), 2, 6, 2, 3)
    lr = 1e-3
    results = {}
    for dtype in ("float32", "bfloat16"):
        model = select_model("2G-GCN", device="cpu", compute_dtype=dtype, **kwargs)
        port = {"model": model.init(torch.Generator().manual_seed(11))}
        opt = torch.optim.Adam(trainable_parameters(port), lr=lr)
        step = make_train_step(model, feeder, criterion, opt)
        losses, _, _ = step(port, data, targets, noise=noise)
        results[dtype] = (losses, port, opt)
    (l32, p32, _), (l16, p16, opt16) = results["float32"], results["bfloat16"]
    np.testing.assert_allclose(l16.numpy(), l32.numpy(), rtol=0.05, atol=0)
    got, want = _flat_tensors(p16["model"]), _flat_tensors(p32["model"])
    assert all(v.dtype == torch.float32 for v in got.values())
    assert all(v.dtype == torch.float32 for state in opt16.state.values()
               for v in state.values() if torch.is_tensor(v) and v.numel() > 1)
    before = _flat_tensors(model.init(torch.Generator().manual_seed(11)))
    grads = {k: w.grad for k, w in want.items() if w.grad is not None}
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        big = g.abs() >= 0.25 * max(float(g.abs().max()), floor)
        moved16, moved32 = torch.sign(got[k] - before[k]), torch.sign(want[k] - before[k])
        assert bool((moved16[big] == moved32[big]).all()), k
    assert not np.allclose(got["/geometry_embedding_gcn/bn/state/var"].numpy(), 1.0)


def test_pad_batch_masks_the_padding():
    batch = _batch(seed=7)
    padded = pad_batch(batch, 3, num_inputs=8)
    assert all(len(x) == 3 for x in padded)
    assert padded[7][-1] == 1.0 and not padded[0][-1].any()
    assert (padded[8][-1] == -1).all() and (padded[13][-1] == -1).all()
    assert pad_batch(batch, 2, num_inputs=8) is batch
    data, targets = select_model_data_fetcher("2G-GCN", "multiple",
                                              dataset_name="mphoi")(padded)
    assert len(data) == 8 and len(targets) == 6


def _load_fixture(path):
    data = np.load(path)
    out = {"input": {}, "target": {}, "weight0": {}, "weightN": {}}
    for key in data.files:
        kind, _, name = key.partition("::")
        if kind in out:
            out[kind][name] = data[key]
    spec = json.loads(bytes(data["meta::spec"]).decode())
    extras = {"mtll_log_sdsN": data["mtll_log_sdsN"]} if "mtll_log_sdsN" in data.files else {}
    targets = [out["target"][k] for k in sorted(out["target"], key=int)]
    return out["input"], targets, data["losses"], out["weight0"], out["weightN"], spec, extras


@pytest.mark.skipif(not FIXTURES, reason="training fixtures not generated")
@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p)[:-4] for p in FIXTURES])
def test_training_trajectory_matches_reference(path):
    inputs, targets, ref_losses, weights0, weights_n, spec, extras = _load_fixture(path)
    dataset = spec["dataset"]
    model = select_model("2G-GCN", device="cpu", **spec["model_kwargs"])
    trainable = {"model": tggcn_params_from_torch_state_dict(weights0, model.config)}
    mtll = None
    if spec.get("mtll"):
        mtll = init_mtll(select_loss_types("2G-GCN", dataset),
                         select_loss_learning_mask("2G-GCN", dataset))
        trainable["mtll"] = mtll["log_sds"]
    criterion, _ = select_loss("2G-GCN", "multiple", dataset, spec["misc"])
    # torch.optim.Adam defaults: betas (0.9, 0.999), eps 1e-8.
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=spec["lr"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           dataset_name=dataset),
                           criterion, optimizer, clip_gradient_at=spec["clip"], mtll=mtll)
    b, t, nh = inputs["x_human"].shape[:3]
    placeholder = np.zeros((b, 1, 1, 1), np.float32)
    batch = [inputs["x_human"], inputs["x_objects"], inputs["objects_mask"],
             np.ones((b, t, nh), np.float32), placeholder, placeholder, placeholder,
             inputs["steps_per_example"]] + targets
    data, target_arrays = select_model_data_fetcher("2G-GCN", "multiple",
                                                    dataset_name=dataset)(batch)
    got_losses = np.asarray([step(trainable, data, target_arrays)[0].numpy()
                             for _ in range(spec["steps"])])
    for s in range(got_losses.shape[0]):
        widen = 1.0 + 0.5 * s
        np.testing.assert_allclose(got_losses[s], ref_losses[s], rtol=5e-3 * widen,
                                   atol=5e-4 * widen, err_msg=f"loss trajectory step {s}")
    if mtll is not None:
        np.testing.assert_allclose(trainable["mtll"].detach().numpy(), extras["mtll_log_sdsN"],
                                   rtol=0, atol=1e-3)
    want = _flat(params_to_numpy(tggcn_params_from_torch_state_dict(weights_n, model.config)))
    got = _flat(params_to_numpy(trainable["model"]))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-3, err_msg=f"weight {k}")


def test_scan_keeps_step_tensors_for_training_only(monkeypatch):
    """The segment scan keeps its per-step messages, gates, mixed messages
    and attention for a train step (whose backward reads them) and nothing
    per step when serving under no_grad: the dot scan runs with keep=True
    in the train step and keep=False in a served request, with the same
    states."""
    from tggcn_torch.models import stage1
    import tggcn_torch.ops.segment_scan as scan_ops

    keeps = []
    plain = scan_ops.segment_scan_dot_plain

    def spy(*args, keep=True, **kwargs):
        keeps.append(keep)
        return plain(*args, keep=keep, **kwargs)

    monkeypatch.setattr(scan_ops, "segment_scan_dot_plain", spy)
    model = select_model("2G-GCN", device="cpu", **dict(stage1.MODEL_KWARGS, hidden_size=8))
    params = model.init(torch.Generator().manual_seed(0))
    request = stage1.make_request(np.random.default_rng(0), b=1, t=3, humans=2, objects=2)
    model.apply(params, **request)
    assert keeps == [False]
    trainable = {"model": params}
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **stage1.FEEDER_KWARGS),
                           criterion, torch.optim.Adam(trainable_parameters(trainable), lr=1e-3))
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")
    data, targets = fetch(stage1.make_batch(np.random.default_rng(1), 2, 3, 2, 2))
    losses, _, _ = step(trainable, data, targets, generator=torch.Generator().manual_seed(2))
    assert keeps == [False, True] and torch.isfinite(losses).all()


def test_bigru_keeps_gates_for_training_only(monkeypatch):
    """The frame BiGRU keeps its gates for a train step (whose backward, K2,
    reads them) and none when serving under no_grad: the recurrence runs
    with keep=True in the train step and keep=False in a served request."""
    from tggcn_torch.models import stage1
    import tggcn_torch.ops.gru_sequence as gru_ops

    keeps = []
    plain = gru_ops.gru_sequence_plain

    def spy(*args, keep=False, **kwargs):
        keeps.append(keep)
        return plain(*args, keep=keep, **kwargs)

    monkeypatch.setattr(gru_ops, "gru_sequence_plain", spy)
    model = select_model("2G-GCN", device="cpu", **dict(stage1.MODEL_KWARGS, hidden_size=8))
    params = model.init(torch.Generator().manual_seed(0))
    request = stage1.make_request(np.random.default_rng(0), b=1, t=3, humans=2, objects=2)
    model.apply(params, **request)
    assert keeps == [False]
    trainable = {"model": params}
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **stage1.FEEDER_KWARGS),
                           criterion, torch.optim.Adam(trainable_parameters(trainable), lr=1e-3))
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")
    data, targets = fetch(stage1.make_batch(np.random.default_rng(1), 2, 3, 2, 2))
    losses, _, _ = step(trainable, data, targets, generator=torch.Generator().manual_seed(2))
    assert keeps == [False, True] and torch.isfinite(losses).all()
