"""Serving configurations of the port on the CPU, against JAX and the
reference fixtures.

* The object-decision rules 'sah' and 'coh' with one human (the only case
  where they differ from 'ind'): the whole forward against JAX
  ``apply_tggcn`` on one init_tggcn parameter set carried over by
  params_from_numpy, decisions by the 'st' threshold. Tolerance rtol 1e-4,
  atol 1e-5, as tests/test_torch_model.py.
* The forward fixtures bimanual_v4_general (bilinear attention, gcn_node
  30) and mphoi_dists (distance-based attention from all three tensors,
  'coh' with two humans) through the port's own state-dict loader, served
  through K5's plain version, at rtol 2e-3, atol 2e-4 as
  tests/test_golden_tggcn.py holds the JAX package.
"""

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_cuda import GOLDEN_DIR, read_fixture
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn_torch.compat.weights import params_from_numpy, tggcn_params_from_torch_state_dict
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn

CONFIG = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=16,
              gcn_node=26, message_segment=True, message_type="v2",
              message_granularity="v1", message_aggregation="att",
              attention_style="v3", discrete_optimization_strategy="st")


@pytest.mark.parametrize("strategy", ["sah", "coh"])
def test_one_human_object_rules_match_jax(strategy):
    kwargs = dict(CONFIG, object_segment_update_strategy=strategy)
    jax_cfg = JaxConfig.from_kwargs(**kwargs)
    jax_params = jax_init(jax.random.PRNGKey(4), jax_cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    rng = np.random.default_rng(4)
    b, t, no = 2, 8, 3
    mask = np.ones((b, no), np.float32)
    mask[1, 1:] = 0.0
    batch = dict(x_human=rng.normal(size=(b, t, 1, 2152)).astype(np.float32),
                 x_objects=rng.normal(size=(b, t, no, 2048)).astype(np.float32),
                 objects_mask=mask, steps_per_example=np.full((b,), float(t), np.float32))
    want, _ = jax_apply(jax_params, jax_cfg, train=False, **batch)
    got, aux = select_model("2G-GCN", device="cpu", **kwargs).apply(params, **batch)
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"output {i}")
    u_h, (u_o, _) = got[0], aux["object_decisions"]
    if strategy == "sah":          # every object commits with the human
        assert torch.equal(u_o, u_h.expand_as(u_o))
    else:                          # an object commits only where the human does
        assert torch.equal(u_o[:, :-1] * (1 - u_h[:, :-1]), torch.zeros_like(u_o[:, :-1]))


@pytest.mark.parametrize("name", ["bimanual_v4_general", "mphoi_dists"])
def test_golden_serving_fixture(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip("golden fixtures not generated")
    inputs, ref_outputs, weights, kwargs, _ = read_fixture(path)
    cfg = TGGCNConfig.from_kwargs(**kwargs)
    params = tggcn_params_from_torch_state_dict(weights, cfg)
    with torch.no_grad():
        outputs, _ = apply_tggcn(params, cfg, **{k: torch.tensor(v) for k, v in inputs.items()})
    assert len(outputs) == len(ref_outputs)
    for i, (got, want) in enumerate(zip(outputs, ref_outputs)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"output {i}")
