"""The port's stage-1 2G-GCN forward against the JAX reference on the CPU.

* The whole forward (``apply`` of select_model) against JAX ``apply_tggcn``
  (XLA path, float32, train=False) on one init_tggcn parameter set carried
  over by params_from_numpy: human segmentation imposed (stage 1) and all
  decisions by the 'st' threshold. Tolerance rtol 1e-4, atol 1e-5: the
  recurrences add up float32 rounding over the sequence.
* The same for concat (v1) attention and mean pooling, served (K5's
  plain version on the CPU).
* The reference fixtures tests/golden/mphoi_st.npz and
  mphoi_hidden128.npz through the port's own state-dict loader, at rtol
  2e-3, atol 2e-4 as tests/test_golden_tggcn.py holds the JAX package.
* The port's state-dict loader against tggcn.compat's on every forward
  fixture.
* In bfloat16 (compute_dtype, as bench.py trains), the stage-1 forward with
  the human segmentation imposed against JAX's bfloat16 XLA route: outputs
  float32, the decisions equal, the heads within 1e-2 absolute (measured
  2.2e-3: the XLA route rounds its recurrent states to bfloat16 at every
  step, the port's kernels and JAX's Pallas kernels keep them float32;
  tests/test_torch_bf16.py holds the port to JAX's kernel route).
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_cuda import GOLDEN_DIR, read_fixture
from tggcn.compat import tggcn_params_from_torch_state_dict as jax_from_state_dict
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn_torch.compat.weights import params_from_numpy, tggcn_params_from_torch_state_dict
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn, init_tggcn

FORWARD_FIXTURES = sorted(
    p for p in glob.glob(os.path.join(GOLDEN_DIR, "*.npz"))
    if not os.path.basename(p).startswith(("baseline_", "training_")))

STAGE1 = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=16,
              gcn_node=26, message_segment=True, message_type="v2",
              message_granularity="v1", message_aggregation="att",
              attention_style="v3", discrete_optimization_strategy="st",
              object_segment_update_strategy="ind")


def _batch(seed=0, b=2, t=8, nh=2, no=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, no), np.float32)
    mask[0, -1] = 0.0
    mask[1, 1:] = 0.0
    return dict(x_human=rng.normal(size=(b, t, nh, 2152)).astype(np.float32),
                x_objects=rng.normal(size=(b, t, no, 2048)).astype(np.float32),
                objects_mask=mask,
                steps_per_example=np.full((b,), float(t), np.float32))


@pytest.fixture(scope="module")
def stage1():
    params = jax_init(jax.random.PRNGKey(0), JaxConfig.from_kwargs(**STAGE1))
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("imposed", [True, False], ids=["imposed_segmentation", "st"])
@pytest.mark.parametrize("style", ["v3", "v2"])
def test_forward_matches_jax(stage1, imposed, style):
    jax_params, params = stage1
    kwargs = dict(STAGE1, attention_style=style)
    model = select_model("2G-GCN", device="cpu", **kwargs)
    batch = _batch(seed=1 if imposed else 2)
    if imposed:
        batch["human_segmentation"] = np.ones(batch["x_human"].shape[:3], np.float32)
    want, want_aux = jax_apply(jax_params, JaxConfig.from_kwargs(**kwargs), train=False,
                               inspect_model=True, **batch)
    got, aux = model.apply(params, inspect_model=True, **batch)
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"output {i}")
    for i, (g, w) in enumerate(zip(aux["attention_scores"], want_aux["attention_scores"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"attention {i}")


def test_bf16_forward_matches_jax_xla_route(stage1):
    jax_params, params = stage1
    kwargs = dict(STAGE1, compute_dtype="bfloat16")
    batch = _batch(seed=1)
    batch["human_segmentation"] = np.ones(batch["x_human"].shape[:3], np.float32)
    want, _ = jax_apply(jax_params, JaxConfig.from_kwargs(**kwargs), train=False, **batch)
    got, aux = select_model("2G-GCN", device="cpu", **kwargs).apply(params, **batch)
    assert len(got) == len(want) == 6
    assert all(g.dtype == torch.float32 for g in got)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-2,
                                       err_msg=f"output {i}")


@pytest.mark.parametrize("change", [{"attention_style": "v1"}, {"message_aggregation": "mp"}],
                         ids=["v1", "mp"])
def test_forward_modes_match_jax(change):
    """Served in a K5 mode, decisions by the 'st' threshold, one object row
    partly and one fully masked."""
    kwargs = dict(STAGE1, **change)
    jax_cfg = JaxConfig.from_kwargs(**kwargs)
    jax_params = jax_init(jax.random.PRNGKey(3), jax_cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    batch = _batch(seed=3)
    # Mean pooling has no attention to inspect: JAX's inspect_model fails on
    # its missing frame attention, and the port reports zeros.
    attention = "message_aggregation" not in change
    want, want_aux = jax_apply(jax_params, jax_cfg, train=False, inspect_model=attention,
                               **batch)
    got, aux = select_model("2G-GCN", device="cpu", **kwargs).apply(params, inspect_model=True,
                                                                    **batch)
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"output {i}")
    for i, g in enumerate(aux["attention_scores"]):
        want_i = np.asarray(want_aux["attention_scores"][i]) if attention else np.zeros(g.shape)
        np.testing.assert_allclose(g.numpy(), want_i, rtol=1e-4, atol=1e-5,
                                   err_msg=f"attention {i}")


def test_init_matches_jax_tree(stage1):
    jax_params, _ = stage1
    params = init_tggcn(torch.Generator().manual_seed(0), TGGCNConfig.from_kwargs(**STAGE1))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes(params) == shapes(jax_params)


@pytest.mark.parametrize("change", [
    {"attention_style": "v1"}, {"attention_style": "v4"}, {"message_aggregation": "mp"},
    {"object_segment_update_strategy": "sah"}, {"object_segment_update_strategy": "coh"}],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_init_modes_match_jax_tree(change):
    """The parameter tree of each serving configuration: the attention
    layers of v1 (MLP) and v4 (bilinear), none under mean pooling, no
    object decision MLP under 'sah'."""
    kwargs = dict(STAGE1, **change)
    jax_params = jax_init(jax.random.PRNGKey(0), JaxConfig.from_kwargs(**kwargs))
    params = init_tggcn(torch.Generator().manual_seed(0), TGGCNConfig.from_kwargs(**kwargs))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes(params) == shapes(jax_params)


@pytest.mark.parametrize("name", ["mphoi_st", "mphoi_hidden128"])
def test_golden_mphoi_st(name):
    """mphoi_st and its hidden-128 twin, whose hard decisions flip under
    reduced-precision matmuls."""
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip("golden fixtures not generated")
    inputs, ref_outputs, weights, kwargs, ref_attention = read_fixture(path)
    cfg = TGGCNConfig.from_kwargs(**kwargs)
    params = tggcn_params_from_torch_state_dict(weights, cfg)
    with torch.no_grad():
        outputs, aux = apply_tggcn(params, cfg, inspect_model=True,
                                   **{k: torch.tensor(v) for k, v in inputs.items()})
    assert len(outputs) == len(ref_outputs)
    for i, (got, want) in enumerate(zip(outputs, ref_outputs)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"output {i}")
    for i, (got, want) in enumerate(zip(aux["attention_scores"], ref_attention)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"attention {i}")


@pytest.mark.skipif(not FORWARD_FIXTURES, reason="golden fixtures not generated")
@pytest.mark.parametrize("path", FORWARD_FIXTURES,
                         ids=[os.path.basename(p)[:-4] for p in FORWARD_FIXTURES])
def test_state_dict_loader_matches_jax(path):
    _, _, weights, kwargs, _ = read_fixture(path)
    want = jax_from_state_dict(weights, JaxConfig.from_kwargs(**kwargs))
    got = tggcn_params_from_torch_state_dict(weights, TGGCNConfig.from_kwargs(**kwargs))
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
