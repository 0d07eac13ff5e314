"""The configurations of the general segment scan on the CPU, against the
reference fixtures (no JAX compile) and by their routing.

* The forward fixtures of tests/golden that the general scan serves:
  CAD-120 (one human, no humans-to-human edge) with 'st' decisions,
  imposed segmentations and filtered decisions, relational messages with
  mean pooling and 'sah' objects, 'specific' messages with mean pooling and
  a geometry-to-human edge, 'specific' messages with concat attention and
  both positional features (Bimanual), and ``message_segment=False`` with
  BatchNorm in train mode (MPHOI); through the port's own state-dict
  loader, at rtol 2e-3, atol 2e-4, as tests/test_golden_tggcn.py holds the
  JAX package.
* The CAD-120 training fixtures (the 12-loss bundle: 'st', MTLL, and the
  stage-2 filtered decisions), as tests/test_torch_train.py holds the
  MPHOI ones, at tests/test_golden_training.py's tolerances.
* Routing: a configuration JAX sends to its general XLA scan goes to the
  port's general scan and never to K3, K4 or K5 (their wrappers and
  autograd Functions replaced by ones that raise), forward and backward;
  a configuration of the fast path never reaches the general scan.
* The CAD-120 recipe (``models/cad120.py``) at hidden 16: a train step of
  each dtype, with and without the distances, gives finite losses that
  reach the segment cells, with both segmentations imposed by the stage-1
  feeder; its batch carries -1 targets in the empty object slots.
"""

import glob
import os

import numpy as np
import pytest
import torch

import test_torch_train as train_tests
from test_torch_cuda import GOLDEN_DIR, read_fixture
from tggcn_torch.compat.weights import tggcn_params_from_torch_state_dict
from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
from tggcn_torch.models import cad120, stage1
from tggcn_torch.models import tggcn as model_module
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn, segment_mode
from tggcn_torch.train.loop import make_train_step, trainable_parameters
from tggcn_torch.train.losses import select_loss

GENERAL_FIXTURES = ("cad120_st", "cad120_gt_seg", "cad120_filter", "cad120_sah_relational_mp",
                    "cad120_specific_mp_geo2h", "bimanual_extras", "mphoi_train_bn")
TRAINING_FIXTURES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "training_train_cad120_*.npz")))


@pytest.mark.parametrize("name", GENERAL_FIXTURES)
def test_golden_fixture_general_scan(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip("golden fixtures not generated")
    inputs, ref_outputs, weights, kwargs, ref_attention = read_fixture(path)
    data = np.load(path)
    train = "meta::train_mode" in data.files and bool(data["meta::train_mode"][0])
    cfg = TGGCNConfig.from_kwargs(**kwargs)
    inputs = {k: torch.tensor(v) for k, v in inputs.items()}
    dists = [inputs.get(k) for k in ("human_human_distances", "human_object_distances",
                                     "object_object_distances")]
    assert segment_mode(cfg, dists) is None
    params = tggcn_params_from_torch_state_dict(weights, cfg)
    with torch.no_grad():
        outputs, aux = apply_tggcn(params, cfg, train=train, inspect_model=bool(ref_attention),
                                   **inputs)
    assert len(outputs) == len(ref_outputs)
    for i, (got, want) in enumerate(zip(outputs, ref_outputs)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"output {i}")
    for i, (got, want) in enumerate(zip(aux.get("attention_scores", []), ref_attention)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"attention {i}")


@pytest.mark.skipif(not TRAINING_FIXTURES, reason="training fixtures not generated")
@pytest.mark.parametrize("path", TRAINING_FIXTURES,
                         ids=[os.path.basename(p)[:-4] for p in TRAINING_FIXTURES])
def test_training_fixture_cad120(path):
    train_tests.test_training_trajectory_matches_reference(path)


# --- Routing -------------------------------------------------------------------------

SMALL = dict(stage1.MODEL_KWARGS, hidden_size=8, discrete_optimization_strategy="st")
# Each case: the change to SMALL, humans, and the distance tensors given.
GENERAL = {
    "cad120_edges": (dict(message_humans_to_human=False), 1, ()),
    "no_segment_messages": (dict(message_segment=False), 2, ()),
    "relational": (dict(message_type="v1"), 2, ()),
    "specific": (dict(message_granularity="v2", attention_style="v4"), 2, ()),
    "partial_distances": ({}, 2, ("human_object_distances", "object_object_distances")),
}
FAST = {
    "dot": ({}, ()),
    "all_distances": ({}, ("human_human_distances", "human_object_distances",
                           "object_object_distances")),
    "mean_pooling_partial_distances": (dict(message_aggregation="mp"),
                                       ("human_object_distances",)),
}


def _request(humans, given, seed=0):
    rng = np.random.default_rng(seed)
    batch = stage1.make_request(rng, 2, 5, humans, 3)
    dists = stage1.make_distances(rng, 2, 5, humans, 3)
    batch.update({k: dists[k] for k in given})
    return batch


def _train_call(model, batch):
    params = model.init(torch.Generator().manual_seed(0))
    for p in trainable_parameters({"model": params}):
        p.requires_grad_(True)
    outputs, _ = model.apply(params, train=True, **batch)
    sum(o.float().mean() for o in outputs[2:]).backward()
    return params


@pytest.mark.parametrize("case", list(GENERAL))
def test_general_configurations_take_the_general_scan(case, monkeypatch):
    change, humans, given = GENERAL[case]
    calls = []
    general = model_module.segment_scan_general

    def spy(*args, **kwargs):
        calls.append(1)
        return general(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel route of the segment scan was taken")

    monkeypatch.setattr(model_module, "segment_scan_general", spy)
    for name in ("segment_scan_forward", "segment_scan_dot_autograd", "segment_scan_recompute",
                 "_segment_scan_fast"):
        monkeypatch.setattr(model_module, name, refuse)
    model = select_model("2G-GCN", device="cpu", **dict(SMALL, **change))
    params = _train_call(model, _request(humans, given))
    assert calls == [1]
    for cell in ("human_segment_rnn_fcell", "human_segment_rnn_bcell"):
        assert float(params[cell]["w_hh"].grad.abs().max()) > 0


@pytest.mark.parametrize("case", list(FAST))
def test_fast_configurations_never_take_the_general_scan(case, monkeypatch):
    change, given = FAST[case]

    def refuse(*args, **kwargs):
        raise AssertionError("the general scan was taken")

    monkeypatch.setattr(model_module, "segment_scan_general", refuse)
    model = select_model("2G-GCN", device="cpu", **dict(SMALL, **change))
    _train_call(model, _request(2, given))


# --- The CAD-120 recipe --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [None, "dist"], ids=["cad120", "cad120_dist"])
def test_cad120_train_step(dtype, variant):
    model = select_model("2G-GCN", device="cpu", **dict(
        cad120.model_kwargs(dtype), hidden_size=16,
        **(cad120.SERVE_VARIANTS[variant] if variant else {})))
    trainable = {"model": model.init(torch.Generator().manual_seed(0))}
    criterion, names = select_loss("2G-GCN", "multiple", cad120.DATASET, cad120.TRAIN["misc"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **cad120.feeder_kwargs(variant)),
                           criterion, torch.optim.Adam(trainable_parameters(trainable),
                                                       lr=cad120.TRAIN["lr"]))
    batch = cad120.make_batch(np.random.default_rng(1), 3, 8, 1, 5, variant=variant)
    empty = batch[2] == 0
    assert empty.any() and (batch[2].sum(1) >= 1).all()
    assert (batch[11][empty[:, None, :].repeat(8, 1)] == -1).all()
    data, targets = select_model_data_fetcher("2G-GCN", "multiple",
                                              dataset_name=cad120.DATASET)(batch)
    assert len(data) == 8 and len(targets) == len(names) == 12
    losses, _, aux = step(trainable, data, targets)
    assert bool(torch.isfinite(losses).all()) and float(losses[names.index("NLL_OAR")]) > 0
    params = trainable["model"]
    assert float(params["object_segment_rnn_fcell"]["w_hh"].grad.abs().max()) > 0
    assert "h2h" not in params
    for key in ("human_decisions", "object_decisions"):
        assert bool((aux[key][0] == 1).all())          # both segmentations imposed


def test_products_save_no_weight_copies():
    """A train forward keeps no copy of a weight expanded over batch rows:
    the frame BiGRU's input projection and the general scan's cell
    products are batched over their stacked cells only. (A product that
    broadcasts a (cells, 1, F, 3h) weight against (cells, rows, ., F)
    inputs copies the weight out for every row and keeps that copy for
    the backward: 1.5 GB in float32 at the CAD-120 width.)"""
    h = 8
    model = select_model("2G-GCN", device="cpu", **dict(cad120.MODEL_KWARGS, hidden_size=h))
    params = model.init(torch.Generator().manual_seed(0))
    for p in trainable_parameters({"model": params}):
        p.requires_grad_(True)
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        model.apply(params, train=True, **cad120.make_request(np.random.default_rng(0), 2, 4, 1,
                                                              5))
    weight_like = [s for s in saved if len(s) >= 3 and s[-1] == 3 * h and s[-2] in (h, 2 * h)]
    assert weight_like                               # the stacked weights themselves
    biggest = max(int(np.prod(s[:-2])) for s in weight_like)
    assert biggest <= 6, f"a weight kept {biggest} times over: {sorted(set(weight_like))}"


@pytest.mark.parametrize("config", ["cad120", "stage1"])
def test_profile_range_splits_the_general_scan(config):
    """profile_step's range_ops, on the CPU ops of a profiled train call:
    the general scan's forward is what runs inside its profiler range, its
    backward what runs inside the backward nodes of the autograd nodes
    made there and the engine's range around each (told apart by sequence
    number), and a model whose scan is the fast path's has neither."""
    from tggcn_torch.models.segment_general import GENERAL_SCAN_RANGE
    from tggcn_torch.profile_step import BACKWARD_SCOPE, range_ops

    kwargs = (dict(cad120.MODEL_KWARGS, hidden_size=8) if config == "cad120"
              else dict(SMALL, **FAST["dot"][0]))
    humans = 1 if config == "cad120" else 2
    model = select_model("2G-GCN", device="cpu", **kwargs)
    batch = (cad120.make_request(np.random.default_rng(0), 2, 4, 1, 5) if config == "cad120"
             else _request(humans, ()))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train_call(model, batch)
    forward, backward = range_ops(prof.events(), GENERAL_SCAN_RANGE)
    if config == "stage1":
        assert forward == [] and backward == []
        return
    ranges = [e for e in prof.events() if e.name == GENERAL_SCAN_RANGE]
    assert len(ranges) == 1
    inside = lambda e: ranges[0].time_range.start <= e.time_range.start <= ranges[0].time_range.end
    assert forward and all(inside(e) and e.thread == ranges[0].thread for e in forward)
    nodes = {e.name for e in backward if e.scope == BACKWARD_SCOPE}
    made = {e.sequence_nr for e in forward if e.sequence_nr >= 0}
    assert {"MmBackward0", "BmmBackward0", "SigmoidBackward0", "TanhBackward0"} <= nodes, nodes
    assert all(e.sequence_nr in made for e in backward if e.scope == BACKWARD_SCOPE)
    # The engine adds up the gradients a node passes on outside the node,
    # inside its own range: those adds belong to the scan's backward too.
    node_of = lambda e: e if e is None or e.scope == BACKWARD_SCOPE else node_of(e.cpu_parent)
    assert any(e.name.startswith("aten::add") and node_of(e) is None for e in backward)
    # The frame BiGRU and the decision MLPs run outside the range, and so
    # do their backward nodes.
    outside = {e.sequence_nr for e in prof.events() if e.sequence_nr >= 0 and not inside(e)
               and e.scope != BACKWARD_SCOPE and not e.name.startswith("autograd::")}
    assert outside and not outside & {e.sequence_nr for e in backward}
