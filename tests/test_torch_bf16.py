"""The port's bfloat16 compute dtype (``compute_dtype="bfloat16"``, the dtype
``bench.py`` trains in) on the CPU, where the kernels take their plain
bfloat16 versions.

* The whole stage-1 forward against JAX's bfloat16 ``apply_tggcn`` with
  ``use_pallas_gru`` and ``use_pallas_segment_scan`` (the Pallas kernels in
  interpret mode, patched in as tests/test_gru_pallas.py and
  tests/test_segment_scan_pallas.py do), on one parameter set carried over
  by params_from_numpy, 'st' decisions: the log-probability heads within
  tests/test_bf16.py's bounds (max < 0.5, mean < 0.05) and within 1e-2
  absolute (the measured gap between JAX's two bfloat16 routes is 2e-3;
  the port rounds its frame messages, decisions and base gates in PyTorch,
  not XLA), the hard decisions equal where their soft score has a margin
  (fewer than 1% flips).
* tests/test_bf16.py's bounds on the port itself: bfloat16 against its own
  float32 (heads max < 0.5, mean < 0.05; margin flips below 1%; soft
  decisions within 0.05), float32 outputs, float32 gradients that reach
  the float32 master parameters, finite, and a loss within rtol 0.05.
* A bfloat16 configuration outside the dot route (K5's bfloat16 variant,
  K6 in float32) serves with float32 outputs, where a float16 one raises
  NotImplementedError; the weight bridge feeds both dtypes; the entry
  point pins bfloat16 products to float32 sums.
"""

import jax
import numpy as np
import pytest
import torch

import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn_torch.compat.weights import params_from_numpy, params_to_numpy
from tggcn_torch.models import stage1
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.tggcn import TGGCNConfig, check_slice
from tggcn_torch.runtime import resolve_device
from tggcn_torch.train.loop import model_parameters

KW = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=16, gcn_node=26,
          message_humans_to_human=True, message_objects_to_human=True,
          message_human_to_objects=True, message_objects_to_object=True,
          message_geometry_to_objects=True, message_segment=True, message_type="v2",
          message_granularity="v1", message_aggregation="att", attention_style="v3",
          discrete_optimization_strategy="st", object_segment_update_strategy="ind")
HEADS = range(2, 6)          # [u_hard, u_soft, frame rec, frame pred, seg rec, seg pred]


@pytest.fixture(scope="module")
def pair():
    """One parameter set and batch (B 2, T 10, 2 humans, 3 objects, an
    object masked), JAX's bfloat16 kernel route, and the port's bfloat16
    and float32 forwards."""
    mp = pytest.MonkeyPatch()
    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    mp.setattr(gru_pallas, "run_multi_bigru_pallas",
               lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    mp.setattr(scan_pallas, "run_segment_scan_pallas",
               lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    params = jax_init(jax.random.PRNGKey(0), JaxConfig(**KW))
    rng = np.random.default_rng(3)
    b, t, nh, no = 2, 10, 2, 3
    batch = dict(x_human=rng.normal(size=(b, t, nh, 2152)).astype(np.float32),
                 x_objects=rng.normal(size=(b, t, no, 2048)).astype(np.float32),
                 objects_mask=np.ones((b, no), np.float32))
    batch["objects_mask"][1, -1] = 0.0
    cfg = JaxConfig(compute_dtype="bfloat16", use_pallas_gru=True,
                    use_pallas_segment_scan=True, **KW)
    try:
        want, _ = jax_apply(params, cfg, train=False, rng=jax.random.PRNGKey(7), **batch)
    finally:
        mp.undo()
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    m16 = select_model("2G-GCN", device="cpu", compute_dtype="bfloat16", **KW)
    m32 = select_model("2G-GCN", device="cpu", **KW)
    out16, _ = m16.apply(tparams, **batch)
    out32, _ = m32.apply(tparams, **batch)
    return dict(jax=[np.asarray(o) for o in want], out16=[o.numpy() for o in out16],
                out32=[o.numpy() for o in out32], params=tparams, batch=batch, m16=m16,
                m32=m32)


def test_forward_matches_jax_bf16_kernel_route(pair):
    for i in HEADS:
        d = np.abs(pair["out16"][i] - pair["jax"][i])
        assert d.max() < 1e-2 and d.mean() < 0.05, f"head {i}: max {d.max()}, mean {d.mean()}"
    hard, soft = pair["out16"][0], pair["jax"][1]
    margin = np.abs(soft - 0.5) > 0.05
    assert np.mean(hard[margin] != pair["jax"][0][margin]) < 0.01


def test_outputs_are_float32_and_bounded_deviation(pair):
    assert all(o.dtype == np.float32 for o in pair["out16"])
    for i in HEADS:
        d = np.abs(pair["out16"][i] - pair["out32"][i])
        assert d.max() < 0.5, f"output {i}: max dev {d.max()}"
        assert d.mean() < 0.05, f"output {i}: mean dev {d.mean()}"


def test_hard_decisions_agree_away_from_threshold(pair):
    hard32, hard16, soft32 = pair["out32"][0], pair["out16"][0], pair["out32"][1]
    margin = np.abs(soft32 - 0.5) > 0.05
    assert np.mean(hard32[margin] != hard16[margin]) < 0.01
    assert np.abs(soft32 - pair["out16"][1]).max() < 0.05


def test_gradients_reach_float32_master_params(pair):
    """The bfloat16 casts sit inside apply on the float32 masters: their
    gradients come back float32 and finite, and the loss stays within
    rtol 0.05 of the float32 route's."""
    def loss(model):
        params = params_from_numpy(params_to_numpy(pair["params"]))
        for p in model_parameters(params):
            p.requires_grad_(True)
        out, _ = model.apply(params, train=True, **pair["batch"])
        total = -out[2].mean() - out[4].mean()
        total.backward()
        grads = [p.grad for p in model_parameters(params) if p.grad is not None]
        return float(total.detach()), grads, model_parameters(params)

    l16, grads, leaves = loss(pair["m16"])
    l32, _, _ = loss(pair["m32"])
    assert all(p.dtype == torch.float32 for p in leaves)
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(l16, l32, rtol=0.05)


@pytest.mark.parametrize("change", [
    {"attention_style": "v1"}, {"attention_style": "v4"}, {"message_aggregation": "mp"},
    {"use_pallas_geo_gcn": True}, {"distances": True}],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_bf16_outside_the_dot_route_raises(change):
    """bfloat16 with another segment mode (v1, v4, mean pooling, distances:
    K5) or the GeoGCN kernel (K6) serves: float32 finite outputs that
    differ from the float32 model's (it does not run in float32 instead).
    The same configuration in float16 raises, naming the dtype."""
    kwargs = dict(KW, hidden_size=8, **{k: v for k, v in change.items() if k != "distances"})
    with pytest.raises(NotImplementedError, match="compute_dtype='float16'"):
        check_slice(TGGCNConfig.from_kwargs(**kwargs, compute_dtype="float16"))
    rng = np.random.default_rng(1)
    batch = stage1.make_request(rng, 1, 3, 2, 2)
    if "distances" in change:
        batch.update(stage1.make_distances(rng, 1, 3, 2, 2))
    outs = {}
    for dtype in ("bfloat16", "float32"):
        model = select_model("2G-GCN", device="cpu", **kwargs, compute_dtype=dtype)
        outs[dtype], _ = model.apply(model.init(torch.Generator().manual_seed(0)), **batch)
    assert all(o.dtype == torch.float32 and bool(torch.isfinite(o).all())
               for o in outs["bfloat16"])
    assert not all(torch.equal(a, b) for a, b in zip(outs["bfloat16"][2:], outs["float32"][2:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bf16"])
def test_weight_bridge_feeds_both_dtypes(pair, dtype):
    """One float32 tree from params_from_numpy serves in either compute
    dtype; the masters stay float32 and untouched."""
    params = params_from_numpy(params_to_numpy(pair["params"]))
    before = params_to_numpy(params)
    model = select_model("2G-GCN", device="cpu", **dict(KW, compute_dtype=dtype))
    out, aux = model.apply(params, **pair["batch"])
    assert all(o.dtype == torch.float32 and bool(torch.isfinite(o).all()) for o in out)
    assert all(x.dtype == torch.float32 for x in aux["object_decisions"])
    want = pair["out32"] if dtype == "float32" else pair["out16"]
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o.numpy(), w)
    after = params_to_numpy(params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, before, after))


def test_stage1_bench_dtype_and_runtime():
    """stage1 names bench.py's dtype; the entry point pins cuBLAS's
    bfloat16 products to float32 sums, as XLA's preferred_element_type."""
    assert stage1.BENCH_DTYPE == "bfloat16"
    assert stage1.model_kwargs()["compute_dtype"] == "float32"
    assert stage1.model_kwargs("bfloat16") == dict(stage1.MODEL_KWARGS,
                                                   compute_dtype="bfloat16")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
