"""The port's stage 2 and the dot route's positional and level-state
features against the JAX reference on the CPU.

* filter_soft_decisions: values and gradient against tggcn's and jax.vjp,
  exactly equal (neighbour ties, values at the threshold, first and last
  frames), in float32 and bfloat16.
* The segmentation-target helpers (ignore_last_step_end_flag_general,
  smooth_segmentation, with -1 padding) and merge_params (a missing key, a
  shape mismatch, a list) against tggcn's, exactly equal.
* make_periodic_embedding, assemble_time_tensor and
  assemble_segment_length_tensor (value and gradient) against tggcn's at
  rtol 1e-6.
* The stage-2 forward (stage2.MODEL_KWARGS at hidden 16: decisions filtered
  at 0.1, 'gs' with the Gumbel noise JAX drew for humans and objects passed
  in, and 'st'), and the same with each of stage2.FEATURE_VARIANTS, against
  JAX apply_tggcn at rtol 1e-4, atol 1e-5; served in the K5 mode 'v1' too.
* Whole-model gradients ('gs', injected noise) against jax.grad of
  apply_tggcn + select_loss with the stage-2 loss bundle (segmentation loss
  on), at rtol 1e-3, atol 1e-5 per leaf as tests/test_torch_train.py holds
  stage 1; in bfloat16 against JAX's bfloat16 kernel route in interpret
  mode, each leaf within 3e-2 of its largest (the one JAX bfloat16 case
  here: its compile takes about a minute).
* The reference fixtures training_train_mphoi_stage2 and
  mphoi_dot_u_periodic_shared through the port's own loader, at the
  tolerances tests/test_torch_train.py and tests/test_torch_model.py hold
  the other fixtures to.
* torch's binary_cross_entropy at inputs of exactly 0 and 1 (the case the
  JAX package's clipped log makes NaN): the reference's value and gradient.
"""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_model as port_model_tests
import test_torch_segment_scan as port_scan_tests
import test_torch_train as port_train_tests
import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
from tggcn.config import Config
from tggcn.data import assembly as jax_assembly
from tggcn.data.loading import select_model_data_feeder as jax_feeder
from tggcn.models import select_model as jax_select_model
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn.nn import temporal as jax_temporal
from tggcn.train.checkpoint import merge_params as jax_merge_params
from tggcn.train.losses import select_loss as jax_select_loss
from tggcn_torch.compat.weights import params_from_numpy, params_to_numpy
from tggcn_torch.data import assembly
from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
from tggcn_torch.models import stage1, stage2
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig, check_slice, init_tggcn
from tggcn_torch.nn import temporal
from tggcn_torch.ops.segment_scan import segment_scan_dot_autograd
from tggcn_torch.train.checkpoint import count_merged, merge_params
from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
from tggcn_torch.train.losses import binary_cross_entropy_loss, select_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, NH, NO = 2, 8, 2, 3
KWARGS = dict(stage2.MODEL_KWARGS, hidden_size=16)
CONFIGS = {"stage2": {}, "stage2_st": dict(discrete_optimization_strategy="st"),
           **stage2.FEATURE_VARIANTS}
MISC = stage2.TRAIN["misc"]
FEEDER = dict(stage2.FEEDER_KWARGS)


def _batch(seed):
    """The 2G-GCN batch list at (B, T, NH, NO): the second clip two frames
    shorter (steps_per_example) with its last labels missing (-1) and an
    object masked; segmentation targets from random end flags smoothed at
    sigma 1 (stage 2's sigma 4 leaves little at T=8), with no -1: where a
    segmentation target is missing, JAX's BCE gradient is NaN (ROADMAP
    Queue 3; test_bce_at_hard_inputs_follows_torch holds the port there)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, NO), np.float32)
    mask[1, -1] = 0.0
    flags = (rng.uniform(size=(B, T, NH)) < 0.3).astype(np.float32)
    flags[:, -1] = 1.0
    y_seg = assembly.assemble_segmentation_targets(flags, 1.0)
    y_rec = rng.integers(0, 13, size=(B, T, NH)).astype(np.int64)
    y_rec[1, -2:] = -1
    y_pred = np.roll(y_rec, -1, axis=1)
    y_pred[:, -1] = -1
    dummy = np.zeros((B, 1, 1, 1), np.float32)
    return [rng.normal(size=(B, T, NH, 2152)).astype(np.float32),
            rng.normal(size=(B, T, NO, 2048)).astype(np.float32), mask, flags,
            dummy, dummy, dummy, np.array([T, T - 2], np.float32),
            y_seg, y_seg, y_rec, y_pred, y_rec, y_pred]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's results per configuration, computed once: 'init' the parameter
    tree, 'forward' a served request (train=False), 'grads' the loss and
    gradients of a train-mode forward with the stage-2 loss bundle."""
    cache = {}

    def run(name, what):
        if (name, what) not in cache:
            cache[name, what] = _jax_run(name, what, cache)
        return cache[name, what]

    return run


def _jax_run(name, what, cache):
    kwargs = dict(KWARGS, **CONFIGS[name])
    if what == "init":
        return jax_init(jax.random.PRNGKey(1), JaxConfig.from_kwargs(**kwargs))
    params = cache.get((name, "init")) or _jax_run(name, "init", cache)
    cache[name, "init"] = params
    batch = _batch(seed=2)
    jax_kwargs = jax_feeder("2G-GCN", "multiple", **FEEDER)(batch[:8])
    rng = jax.random.PRNGKey(3)
    if what == "forward":
        return jax_apply(params, JaxConfig.from_kwargs(**kwargs), train=False, rng=rng,
                         inspect_model=True, **jax_kwargs)
    model = jax_select_model("2G-GCN", **kwargs)
    criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": MISC}))

    def loss(p):
        out, _ = model.apply(p, train=True, rng=rng, **jax_kwargs)
        return sum(criterion(out, batch[8:])), out

    return jax.value_and_grad(loss, has_aux=True)(params)


def _port(name, jax_params, **extra):
    model = select_model("2G-GCN", device="cpu", **dict(KWARGS, **CONFIGS[name], **extra))
    return model, params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))


def _noise(strategy, dtype=jnp.float32):
    if strategy not in {"gs", "gumbel-sigmoid"}:
        return None
    return port_train_tests._jax_noise(jax.random.PRNGKey(3), B, T, NH, NO, dtype)


# --- filter_soft_decisions ---------------------------------------------------


def _soft_decisions(threshold, dtype):
    """(B=3, T=9, E=2) soft decisions with neighbour ties, values at the
    threshold and maxima on the first and last frames."""
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(3, 9, 2)).astype(np.float32)
    u[0, :, 0] = [0.9, 0.2, 0.6, 0.6, 0.1, threshold, 0.05, 0.3, 0.8]
    u[0, :, 1] = [threshold] * 9
    u[1, :, 0] = [0.3, 0.7, 0.7, 0.2, threshold, 0.0, 1.0, 0.5, 0.5]
    u[2, 3:6, 1] = threshold
    u[2, 4, 1] = np.nextafter(np.float32(threshold), np.float32(1))
    return np.asarray(jnp.asarray(u, dtype).astype(jnp.float32)) if dtype != jnp.float32 else u


@pytest.mark.parametrize("threshold", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_soft_decisions_matches_jax(threshold, dtype):
    u = _soft_decisions(threshold, getattr(jnp, dtype))
    cot = np.random.default_rng(1).normal(size=u.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want, vjp = jax.vjp(lambda x: jax_temporal.filter_soft_decisions(x, threshold),
                        jnp.asarray(u, jdt))
    (want_grad,) = vjp(jnp.asarray(cot, jdt))
    x = torch.tensor(u).to(getattr(torch, dtype)).requires_grad_(True)
    got = temporal.filter_soft_decisions(x, threshold)
    got.backward(torch.tensor(cot).to(x.dtype))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(want_grad.astype(jnp.float32)))
    # A local maximum at or above the threshold commits (1); nothing else does.
    assert set(np.unique(got.detach().float().numpy())) <= {0.0, 1.0}
    assert got[0, 0, 0] == 1 and got[0, -1, 0] == 1 and not got[0, 2:4, 0].any()


def _sparse_commits(a, seed):
    """The scan inputs a with stage 2's commits: u_h and u_o the filtered
    decisions of random soft values at threshold 0.1, 1 at local maxima
    and 0 elsewhere."""
    rng = np.random.default_rng(seed)
    for k in ("u_h", "u_o"):
        soft = torch.tensor(rng.uniform(size=a[k].shape).astype(np.float32)).transpose(0, 1)
        a[k] = temporal.filter_soft_decisions(soft, 0.1).transpose(0, 1).numpy()
    return a


def test_scan_sparse_commits_match_pallas(monkeypatch):
    """K3's and K4's plain versions under stage 2's sparse commits (the state
    held over most frames, du_h reaching the decisions) against the Pallas
    segment kernel in interpret mode: the segment-scan tests' float32
    forward and bfloat16 forward and backward with sparse commits, and the
    float32 gradients against jax.vjp at rtol 1e-4, atol 1e-5."""
    inputs = port_scan_tests._inputs
    monkeypatch.setattr(port_scan_tests, "_inputs",
                        lambda *args, **kw: _sparse_commits(inputs(*args, **kw), 8))
    port_scan_tests.test_segment_scan_matches_pallas(2, "v3")
    port_scan_tests.test_bf16_plain_versions_match_pallas(2)
    t, b, nh, no, h = 9, 3, 2, 3, 8
    a = port_scan_tests._inputs(t, b, nh, no, h, seed=31)
    assert 0 < a["u_h"].mean() < 0.5 and set(np.unique(a["u_o"])) == {0.0, 1.0}
    rng = np.random.default_rng(32)
    scale = 1.0 / math.sqrt(h)
    g_h, g_o, g_att = (rng.normal(size=(2, t, b, n, w)).astype(np.float32)
                       for n, w in ((nh, h), (no, h), (nh, no)))
    want = port_scan_tests._jax_vjp(a, nh, no, scale, g_h, g_o, g_att)
    leaves = {k: torch.tensor(v, requires_grad=k in port_scan_tests.DIFFERENTIABLE)
              for k, v in a.items()}
    out = segment_scan_dot_autograd(**leaves, scale=scale)
    torch.autograd.backward(list(out), [torch.tensor(g) for g in (g_h, g_o, g_att)])
    for k in port_scan_tests.DIFFERENTIABLE:
        np.testing.assert_allclose(leaves[k].grad.numpy(), want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# --- Data assembly and warm starts --------------------------------------------


@pytest.mark.parametrize("sigma", [0.0, 4.0])
def test_segmentation_targets_match_jax(sigma):
    rng = np.random.default_rng(3)
    flags = (rng.uniform(size=(4, 30, 3)) < 0.15).astype(np.float32)
    flags[0, :, 1] = 0.0                        # an entity with no end flag
    flags[1, -5:] = -1.0                        # padding
    flags[2, -1] = 1.0
    keep = flags.copy()
    want_flags = jax_assembly.ignore_last_step_end_flag_general(flags.copy())
    got_flags = assembly.ignore_last_step_end_flag_general(flags)
    np.testing.assert_array_equal(got_flags, want_flags)
    want = jax_assembly.smooth_segmentation(want_flags.copy(), sigma)
    np.testing.assert_array_equal(assembly.smooth_segmentation(got_flags, sigma), want)
    # As assemble_mphoi_tensors applies them, and without touching the input.
    np.testing.assert_array_equal(assembly.assemble_segmentation_targets(flags, sigma),
                                  want if sigma else jax_assembly.smooth_segmentation(
                                      flags.copy(), sigma))
    np.testing.assert_array_equal(flags, keep)
    assert (want[1, -5:] == -1).all() and (want[want != -1] >= 0).all()


def test_merge_params_matches_jax():
    """A missing key and an extra one, a shape mismatch at a tensor and a
    list of layers of other widths (taken whole, as JAX takes it)."""
    rng = np.random.default_rng(4)
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    init = {"mlp": {"layers": [{"w": a(3, 4), "b": a(4)}]}, "cell": {"w": a(2, 2), "b": a(2)},
            "only_init": {"w": a(5)}, "head": {"w": a(4, 13)}}
    loaded = {"mlp": {"layers": [{"w": a(3, 5), "b": a(5)}]}, "cell": {"w": a(2, 3), "b": a(2)},
              "only_loaded": {"w": a(1)}, "head": {"w": a(4, 13)}}
    want = jax_merge_params(copy.deepcopy(init), copy.deepcopy(loaded))
    init_t = params_from_numpy(init)
    got = merge_params(init_t, params_from_numpy(loaded))
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    flat_got, tree_got = jax.tree_util.tree_flatten(params_to_numpy(got))
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)
    assert got["cell"]["w"] is init_t["cell"]["w"] and got["only_init"] is init_t["only_init"]
    assert count_merged(init_t, got) == 4          # the list's two leaves, cell b, head w


def test_stage1_weights_warm_start_stage2():
    """Every leaf of a stage-1 tree lands in the stage-2 tree: the widths are
    the same and only the decision rule differs."""
    cfg1 = TGGCNConfig.from_kwargs(**dict(stage1.MODEL_KWARGS, hidden_size=8))
    cfg2 = TGGCNConfig.from_kwargs(**dict(stage2.MODEL_KWARGS, hidden_size=8))
    p1 = init_tggcn(torch.Generator().manual_seed(0), cfg1)
    p2 = init_tggcn(torch.Generator().manual_seed(1), cfg2)
    merged = merge_params(p2, p1)
    n = len(jax.tree_util.tree_leaves(p2))
    assert count_merged(p2, merged) == n
    for g, w in zip(jax.tree_util.tree_leaves(merged), jax.tree_util.tree_leaves(p1)):
        assert g is w


# --- Positional features --------------------------------------------------------


@pytest.mark.parametrize("ignore_div", [False, True])
def test_positional_features_match_jax(ignore_div):
    rng = np.random.default_rng(5)
    steps = np.array([12.0, 9.0, 5.0], np.float32)
    want_time = jax_temporal.assemble_time_tensor(jnp.asarray(steps), 12, ignore_div)
    got_time = temporal.assemble_time_tensor(torch.tensor(steps), 12, ignore_div)
    np.testing.assert_allclose(got_time.numpy(), np.asarray(want_time), rtol=1e-6)
    for width in (16, 24):
        np.testing.assert_allclose(
            temporal.make_periodic_embedding(got_time, width).numpy(),
            np.asarray(jax_temporal.make_periodic_embedding(want_time, width)),
            rtol=1e-6, atol=1e-7)
    # Hard decisions: a row with no end frame, ends on the first and last
    # frames, neighbouring ends.
    u = (rng.uniform(size=(3, 12, 4)) < 0.3).astype(np.float32)
    u[0, :, 0] = 0.0
    u[1, :, 1] = 0.0
    u[1, [0, 1, 11], 1] = 1.0
    cot = rng.normal(size=u.shape + (1,)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax_temporal.assemble_segment_length_tensor(
        x, jnp.asarray(steps), ignore_div), jnp.asarray(u))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.tensor(u, requires_grad=True)
    got = temporal.assemble_segment_length_tensor(x, torch.tensor(steps), ignore_div)
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    # JAX's reverse scan adds and takes away the accumulator's cotangent at
    # every end frame, so its gradient carries the rounding of the largest
    # one: within a millionth of the largest gradient.
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-6,
                               atol=1e-6 * np.abs(want_grad).max())


# --- The model ------------------------------------------------------------------


def test_check_slice_takes_the_stage2_yaml():
    with open(os.path.join(ROOT, "conf", "models", "2G-GCN_stage2.yaml")) as f:
        block = yaml.safe_load(f)["parameters"]
    kwargs = dict(block, input_size=(2152, 2048), num_classes=(13, None))
    for dtype in ("float32", "bfloat16"):
        check_slice(TGGCNConfig.from_kwargs(**kwargs, compute_dtype=dtype))
        for change in stage2.FEATURE_VARIANTS.values():
            check_slice(TGGCNConfig.from_kwargs(**dict(kwargs, **change), compute_dtype=dtype))
    assert {k: block[k] for k in ("filter_discrete_updates", "update_segment_threshold",
                                  "discrete_optimization_strategy")} == {
        k: stage2.MODEL_KWARGS[k] for k in ("filter_discrete_updates",
                                            "update_segment_threshold",
                                            "discrete_optimization_strategy")}


@pytest.mark.parametrize("name", list(CONFIGS) + ["cat_only", "share_only"])
def test_init_matches_jax_tree(jax_runs, name):
    change = {"cat_only": dict(cat_level_states=True), "share_only": dict(share_level_mlps=True,
              add_segment_length=True, positional_encoding_style="p")}.get(name, CONFIGS.get(name))
    kwargs = dict(KWARGS, **change)
    want = (jax_runs(name, "init") if name in CONFIGS
            else jax_init(jax.random.PRNGKey(0), JaxConfig.from_kwargs(**kwargs)))
    got = init_tggcn(torch.Generator().manual_seed(0), TGGCNConfig.from_kwargs(**kwargs))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes(got) == shapes(want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(jax_runs, name):
    want, want_aux = jax_runs(name, "forward")
    model, params = _port(name, jax_runs(name, "init"))
    batch = select_model_data_feeder("2G-GCN", "multiple", **FEEDER)(_batch(seed=2)[:8])
    got, aux = model.apply(params, inspect_model=True,
                           noise=_noise(model.config.discrete_optimization_strategy), **batch)
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0 < float(got[0].sum()) < got[0].numel()      # the filter committed some frames
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"output {i}")
    for i, (g, w) in enumerate(zip(aux["attention_scores"], want_aux["attention_scores"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"attention {i}")
    assert aux["human_decisions"][0] is got[0]


def test_forward_k5_mode_matches_jax():
    """The filter and the features served in a K5 mode ('v1' attention):
    they change only the scan's decisions and its input projection."""
    kwargs = dict(KWARGS, attention_style="v1", **stage2.FEATURE_VARIANTS["s_embedding_length_cat"])
    jax_params = jax_init(jax.random.PRNGKey(5), JaxConfig.from_kwargs(**kwargs))
    batch = select_model_data_feeder("2G-GCN", "multiple", **FEEDER)(_batch(seed=6)[:8])
    want, _ = jax_apply(jax_params, JaxConfig.from_kwargs(**kwargs), train=False,
                        rng=jax.random.PRNGKey(3), **batch)
    model = select_model("2G-GCN", device="cpu", **kwargs)
    got, _ = model.apply(params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params)),
                         noise=_noise("gs"), **batch)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"output {i}")


def _port_grads(model, params, noise):
    for p in model_parameters(params):
        p.requires_grad_(True)
    data = _batch(seed=2)
    out, _ = model.apply(params, train=True, noise=noise,
                         **select_model_data_feeder("2G-GCN", "multiple", **FEEDER)(data[:8]))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    total = sum(criterion(out, [torch.tensor(y) for y in data[8:]]))
    total.backward()
    return out, total, {k: leaf.grad for k, leaf in port_train_tests._flat_tensors(params).items()
                        if leaf.grad is not None}


@pytest.mark.parametrize("name", ["stage2"] + list(stage2.FEATURE_VARIANTS))
def test_model_gradients_match_jax(jax_runs, name):
    (want_total, want_out), want_grads = jax_runs(name, "grads")
    model, params = _port(name, jax_runs(name, "init"))
    out, total, got = _port_grads(model, params, _noise("gs"))
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(want_out[0]))
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    want = {k: v for k, v in port_train_tests._flat(want_grads).items() if "/bn/state/" not in k}
    assert set(got) <= set(want)
    # The human decisions are learned: their MLP's gradient arrives through
    # the filter's straight-through term (the segment scan's du_h).
    assert float(got["/update_human_segment_mlp/layers/0/w"].abs().max()) > 0
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)


def test_bf16_model_gradients_match_jax(monkeypatch):
    """Stage 2 in bfloat16 against JAX's bfloat16 kernel route (its Pallas
    kernels in interpret mode), 'gs' with JAX's bfloat16 draws: the loss
    within rtol 1e-3; the gradient that reaches the filtered decisions
    (through K4's du and the filter, read by adding a zero to the filter's
    input and output on both sides) within two bfloat16 ulps of its largest;
    each parameter leaf within 3e-2 of its largest, as
    tests/test_torch_train.py holds stage 1, except the one-element bias of
    each decision MLP, held to 3e-2 of its layer's largest gradient. That
    bias's gradient is the sum of the decision logits' gradients over every
    frame and entity, which cancel (measured: 1.95e-3 against a weight
    gradient of 3.9e-2), and bfloat16 rounds each of them: the port lies
    0.17 of the sum from JAX, 9e-3 of the layer's largest, where JAX's
    XLA route lies 0.031 of the sum from its kernel route."""
    import tggcn.models.tggcn as jax_model_module
    import tggcn_torch.models.tggcn as port_model_module

    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    monkeypatch.setattr(gru_pallas, "run_multi_bigru_pallas",
                        lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(scan_pallas, "run_segment_scan_pallas",
                        lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    kwargs = dict(KWARGS, compute_dtype="bfloat16")
    jax_model = jax_select_model("2G-GCN", use_pallas_gru=True, use_pallas_segment_scan=True,
                                 **kwargs)
    jax_params = jax_model.init(jax.random.PRNGKey(1))
    data = _batch(seed=2)
    jax_kwargs = jax_feeder("2G-GCN", "multiple", **FEEDER)(data[:8])
    criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": MISC}))
    rng = jax.random.PRNGKey(3)
    shapes = [(B, T, NH)] * 2 + [(B, T, NO)] * 2        # input, output; humans, objects

    def probed(module, filt, probes, cast):
        """The model module's filter with probes[2i] added to its input and
        probes[2i + 1] to its output on its i-th call (humans, then objects)."""
        calls = []

        def f(u, threshold):
            i = 2 * len(calls)
            calls.append(i)
            return filt(u + cast(probes[i], u.dtype), threshold) + cast(probes[i + 1], u.dtype)
        monkeypatch.setattr(module, "filter_soft_decisions", f)

    def loss(p, probes):
        probed(jax_model_module, jax_temporal.filter_soft_decisions, probes,
               lambda x, dtype: x.astype(dtype))
        out, _ = jax_model.apply(p, train=True, rng=rng, **jax_kwargs)
        return sum(criterion(out, data[8:])), out

    (want_total, want_out), (want_grads, want_probes) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jax_params, [jnp.zeros(s) for s in shapes])
    probes = [torch.zeros(s, requires_grad=True) for s in shapes]
    probed(port_model_module, temporal.filter_soft_decisions, probes,
           lambda x, dtype: x.to(dtype))
    model = select_model("2G-GCN", device="cpu", **kwargs)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    out, total, got = _port_grads(model, params, _noise("gs", jnp.bfloat16))
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(want_out[0]))
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-3)
    for i, (p, w) in enumerate(zip(probes, want_probes)):
        w = np.asarray(w)
        assert np.abs(p.grad.numpy() - w).max() <= 2 * bf16_ulp(np.abs(w).max()), i
    assert all(g.dtype == torch.float32 for g in got.values())
    want = {k: v for k, v in port_train_tests._flat(want_grads).items() if "/bn/state/" not in k}
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        scale = np.abs(w).max()
        if k.endswith("_segment_mlp/layers/0/b"):
            scale = max(scale, np.abs(want[k[:-1] + "w"]).max())
        assert np.abs(g - w).max() <= 3e-2 * max(float(scale), floor), k


def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


# --- Reference fixtures ----------------------------------------------------------


def test_training_fixture_stage2():
    """training_train_mphoi_stage2 (the original 2G-GCN, hidden 24: 'st'
    decisions filtered at 0.1, the segmentation loss on, 5 Adam steps),
    held as tests/test_torch_train.py holds the stage-1 training fixtures."""
    path = os.path.join(port_train_tests.GOLDEN_DIR, "training_train_mphoi_stage2.npz")
    if not os.path.exists(path):
        pytest.skip("training fixtures not generated")
    port_train_tests.test_training_trajectory_matches_reference(path)


def test_golden_mphoi_dot_u_periodic_shared():
    """The dot route with the time position as a decision input ('u'), the
    periodic encoding and shared level heads, at rtol 2e-3, atol 2e-4."""
    port_model_tests.test_golden_mphoi_st("mphoi_dot_u_periodic_shared")


# --- Stage-2 training on the CPU -----------------------------------------------------


def test_stage2_train_step_from_stage1_weights():
    """The stage-2 recipe at a small size: stage2.make_batch, a warm start
    from stage-1 weights, stage2.TRAIN and FEEDER_KWARGS; the humans'
    decision MLP learns, the losses are finite and the segmentation loss is
    on."""
    model1 = select_model("2G-GCN", device="cpu", **dict(stage1.MODEL_KWARGS, hidden_size=8))
    model = select_model("2G-GCN", device="cpu", **dict(stage2.MODEL_KWARGS, hidden_size=8))
    params = merge_params(model.init(torch.Generator().manual_seed(1)),
                          model1.init(torch.Generator().manual_seed(0)))
    trainable = {"model": params}
    criterion, names = select_loss("2G-GCN", "multiple", "mphoi", stage2.TRAIN["misc"])
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage2.TRAIN["lr"])
    step = make_train_step(model, select_model_data_feeder("2G-GCN", "multiple",
                                                           **stage2.FEEDER_KWARGS),
                           criterion, optimizer, clip_gradient_at=stage2.TRAIN["clip"])
    batch = stage2.make_batch(np.random.default_rng(2), 2, 50, 2, 3)
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(batch)
    losses, _, aux = step(trainable, data, targets, generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(losses).all() and float(losses[names.index("BCE_HS")]) > 0
    assert float(params["update_human_segment_mlp"]["layers"][0]["w"].grad.abs().max()) > 0
    assert set(aux["human_decisions"][0].unique().tolist()) <= {0.0, 1.0}


def test_make_batch_segments():
    flags, labels, following = stage2.make_segments(np.random.default_rng(7), 3, 167, 2)
    for i in range(3):
        for n in range(2):
            ends = np.flatnonzero(flags[i, :, n])
            assert ends[-1] == 166
            lengths = np.diff(np.concatenate([[-1], ends]))
            assert (lengths[:-1] >= 8).all() and (lengths <= 40).all()
            starts = np.concatenate([[0], ends[:-1] + 1])
            for s, e in zip(starts, ends):
                assert (labels[i, s:e + 1, n] == labels[i, s, n]).all()
            assert (np.diff(labels[i, starts, n]) != 0).all()
            assert (following[i, starts[-1]:, n] == -1).all()
            assert (following[i, :starts[-1], n] >= 0).all()
    batch = stage2.make_batch(np.random.default_rng(7), 3, 167, 2, 4)
    np.testing.assert_array_equal(batch[8],
                                  assembly.assemble_segmentation_targets(batch[3], 4.0))
    assert 0 < batch[8].max() <= 1 and batch[8].min() >= 0


# --- BCE at hard inputs --------------------------------------------------------------


def test_bce_at_hard_inputs_follows_torch():
    """Inputs of exactly 0 and 1 against smoothed targets: the value and
    gradient of torch's binary_cross_entropy, which the reference training
    (and its stage-2 fixture) ran: each log clamped at -100, the gradient
    (x - t) / max(x (1 - x), 1e-12) / n. The JAX package's clipped log
    gives the same value and a NaN gradient there (an intentional
    divergence, ROADMAP Queue 3). In the MPHOI bundle BCE reads the soft
    decisions (output 1), so the case arises where a soft decision
    saturates, not at the filtered hard ones."""
    x = torch.tensor([0.0, 1.0, 0.5, 1.0, 0.0, 1.0], requires_grad=True)
    t = torch.tensor([0.3, 0.3, 0.3, -1.0, -1.0, 0.0])
    loss = binary_cross_entropy_loss(x, t)
    loss.backward()
    n, kept = x.numel(), (t != -1).float()
    xd, td = x.detach().double() * kept.double(), t.double() * kept.double()
    want = -(td * torch.clamp(torch.log(xd), min=-100)
             + (1 - td) * torch.clamp(torch.log(1 - xd), min=-100)).mean() * n / kept.sum()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    grad = (xd - td) / torch.clamp(xd * (1 - xd), min=1e-12) / kept.sum() * kept
    np.testing.assert_allclose(x.grad.double().numpy(), grad.numpy(), rtol=1e-6)
    assert torch.isfinite(x.grad).all() and float(x.grad[0]) < -1e10
    from tggcn.train.losses import binary_cross_entropy_loss as jax_bce
    jax_grad = jax.grad(lambda v: jax_bce(v, jnp.asarray(t.numpy())))(jnp.asarray(
        x.detach().numpy()))
    np.testing.assert_allclose(float(jax_bce(jnp.asarray(x.detach().numpy()),
                                             jnp.asarray(t.numpy()))), float(loss.detach()),
                               rtol=1e-6)
    assert np.isnan(np.asarray(jax_grad)[[0, 1]]).all()
    # The stage-2 bundle's BCE term is the soft decisions' (outputs[1]).
    criterion, names = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    hard, soft = torch.tensor([[[0.0, 1.0]]]), torch.tensor([[[0.2, 0.7]]])
    heads = [torch.zeros(1, 13, 1, 2)] * 4
    target = torch.tensor([[[0.3, 0.6]]])
    terms = criterion([hard, soft] + heads, [target, target] + [torch.zeros(1, 1, 2)] * 4)
    np.testing.assert_allclose(float(terms[names.index("BCE_HS")]),
                               float(binary_cross_entropy_loss(soft, target)), rtol=1e-6)
