"""Training the segment scan's other attention modes on the CPU against the
JAX package: concat (v1) and bilinear (v4) attention, mean pooling (mp)
and distance-based attention with the GeoGCN kernel (dist), the four
``stage1.SERVE_VARIANTS``.

The port runs K5's plain version forward and takes its gradients from the
fast path's counterpart (``models/segment_fast.py``) recomputed at the
saved inputs; JAX runs its Pallas kernel (interpret mode) under the custom
VJP that recomputes through its XLA fast path
(``use_pallas_segment_scan=True, segment_kernel_modes="all"``), with the
GeoGCN kernel's in 'dist'. Whole-model gradients of the MPHOI loss bundle
('gs' decisions with JAX's Gumbel draws passed in):

* float32, each variant: the loss at rtol 1e-5, every leaf at rtol 1e-3,
  atol 1e-5, as tests/test_torch_train.py holds the dot route;
* bfloat16, 'mp': the loss at rtol 1e-3, each leaf within 3e-2 of its
  largest value (or of a millionth of the largest gradient), as
  tests/test_torch_train.py holds the dot route in bfloat16. (In 'v1' and
  'v4' a few small segment attention and message leaves lie further from
  JAX's: both sides recompute the scan with bfloat16 states, and those
  leaves sum small terms that cancel. JAX's kernel route cannot train
  'dist' in bfloat16: its custom VJP meets a float32 cotangent for a
  bfloat16 output.)
* stage 2 in 'v4': tests/test_torch_modes.py (the two files split the
  JAX compiles between two test workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_stage2 as stage2_tests
import test_torch_train as train_tests
import tggcn.ops.geo_gcn_pallas as geo_pallas
import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
from tggcn.config import Config
from tggcn.data.loading import select_model_data_feeder as jax_feeder
from tggcn.models import select_model as jax_select_model
from tggcn.train.losses import select_loss as jax_select_loss
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.data.feeders import select_model_data_feeder
from tggcn_torch.models import stage1, stage2
from tggcn_torch.models.registry import select_model
from tggcn_torch.train.loop import model_parameters
from tggcn_torch.train.losses import select_loss

B, T, NH, NO = 2, 6, 2, 3


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, as tests/test_torch_bf16.py
    runs them on the CPU."""
    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    fused = geo_pallas.geo_gcn_fused
    monkeypatch.setattr(gru_pallas, "run_multi_bigru_pallas",
                        lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(scan_pallas, "run_segment_scan_pallas",
                        lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(geo_pallas, "geo_gcn_fused", lambda *a: fused(*a, 16, True))


def _data(variant, batch):
    """The batch list with the three distance tensors in their places for
    'dist', and the feeder's keywords."""
    feeder = dict(dataset_name="mphoi")
    if variant == "dist":
        batch = list(batch)
        batch[4:7] = stage1.make_distances(np.random.default_rng(5), B, T, NH, NO).values()
        feeder["make_attention_distance_based"] = True
    return batch, feeder


def _grads(kwargs, batch, feeder, misc, noise):
    """(JAX's loss and gradients, the port's loss and gradients) of one
    train-mode forward with the MPHOI loss bundle, JAX drawing its Gumbel
    noise from PRNGKey(3) and the port given the same draws (noise)."""
    jax_model = jax_select_model("2G-GCN", use_pallas_gru=True, use_pallas_segment_scan=True,
                                 segment_kernel_modes="all", **kwargs)
    jax_params = jax_model.init(jax.random.PRNGKey(1))
    data, targets = batch[:8], batch[8:]
    jax_kwargs = jax_feeder("2G-GCN", "multiple", **feeder)(data)
    criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": misc}))
    rng = jax.random.PRNGKey(3)

    def jax_loss(p):
        out, _ = jax_model.apply(p, train=True, rng=rng, **jax_kwargs)
        return sum(criterion(out, targets)), out

    (want_total, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_params)
    model = select_model("2G-GCN", device="cpu", **kwargs)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    for p in model_parameters(params):
        p.requires_grad_(True)
    out, _ = model.apply(params, train=True, noise=noise,
                         **select_model_data_feeder("2G-GCN", "multiple", **feeder)(data))
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(want_out[0]))
    port_criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", misc)
    total = sum(port_criterion(out, [torch.tensor(y) for y in targets]))
    total.backward()
    got = {k: leaf.grad for k, leaf in train_tests._flat_tensors(params).items()
           if leaf.grad is not None}
    want = {k: v for k, v in train_tests._flat(want_grads).items() if "/bn/state/" not in k}
    assert set(got) <= set(want)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in got.values())
    return float(want_total), float(total.detach()), want, got


def _noise(dtype=jnp.float32):
    return train_tests._jax_noise(jax.random.PRNGKey(3), B, T, NH, NO, dtype)


@pytest.mark.parametrize("variant", list(stage1.SERVE_VARIANTS))
def test_mode_gradients_match_jax(interpret, variant):
    kwargs = dict(train_tests.STAGE1, discrete_optimization_strategy="gs",
                  **stage1.SERVE_VARIANTS[variant])
    batch, feeder = _data(variant, train_tests._batch(seed=2))
    want_total, total, want, got = _grads(kwargs, batch, feeder, train_tests.MISC, _noise())
    np.testing.assert_allclose(total, want_total, rtol=1e-5)
    # The segment scan's parameters are reached (the attention's too, where
    # the mode scores).
    assert float(got["/human_segment_rnn_fcell/w_hh"].abs().max()) > 0
    if variant in ("v1", "v4"):
        assert float(got["/o2h/segment/att/" + ("layers/0/w" if variant == "v1" else "w")]
                     .abs().max()) > 0
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)


def test_bf16_mode_gradients_match_jax(interpret):
    kwargs = dict(train_tests.STAGE1, discrete_optimization_strategy="gs",
                  compute_dtype="bfloat16", **stage1.SERVE_VARIANTS["mp"])
    batch, feeder = _data("mp", train_tests._batch(seed=2))
    want_total, total, want, got = _grads(kwargs, batch, feeder, train_tests.MISC,
                                          _noise(jnp.bfloat16))
    np.testing.assert_allclose(total, want_total, rtol=1e-3)
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        assert np.abs(g - w).max() <= 3e-2 * max(float(np.abs(w).max()), floor), k
