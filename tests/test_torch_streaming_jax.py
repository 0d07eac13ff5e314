"""The port's streaming carry against the JAX package's, on the CPU.

* ``apply_tggcn(..., carry=..., return_carry=True,
  force_last_step_commit=False, frame_offset=5)`` with seeded carries for
  all five states, against JAX's with its Pallas kernels in interpret mode
  (``use_pallas_gru``, ``use_pallas_segment_scan``, every segment mode on
  the kernel), on one parameter set carried over by ``params_from_numpy``,
  the human segmentation imposed and the objects' 'st' decisions taken:
  in float32 and bfloat16, for the 'dot' route (K3) and 'v1' (K5).
  Float32: every output and carry sequence within rtol 2e-4, atol 2e-5.
  Bfloat16 (the carries cast to bfloat16 on entry, as JAX casts them,
  while both kernels carry float32 inside a call), with the objects'
  segmentation imposed too, so that a decision marginal in bfloat16 cannot
  flip between the routes: the heads within 1e-2 absolute,
  tests/test_torch_bf16.py's bound, and each carry sequence within two
  bfloat16 ulps of its largest value (as tests/test_torch_modes.py holds
  the segment scan's outputs).
* The port's ``StreamingRunner`` against JAX's (its XLA route, 'st'
  decisions, bounded lookahead, interior windows and a short last chunk):
  every stitched output within rtol 2e-4, atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
from tggcn.models.streaming import StreamingRunner as JaxStreamingRunner
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.streaming import StreamingRunner

KW = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=16, gcn_node=26,
          message_humans_to_human=True, message_objects_to_human=True,
          message_human_to_objects=True, message_objects_to_object=True,
          message_geometry_to_objects=True, message_segment=True, message_type="v2",
          message_granularity="v1", message_aggregation="att", attention_style="v3",
          discrete_optimization_strategy="st", object_segment_update_strategy="ind",
          geometry_flatten="per_frame")
CARRIES = {"frame_human": 2, "frame_object": 3, "frame_geometry": 1, "seg_human": 2,
           "seg_object": 3}
HEADS = range(2, 6)          # [u_hard, u_soft, frame rec, frame pred, seg rec, seg pred]


@pytest.fixture(scope="module")
def interpret():
    """JAX's Pallas kernels in interpret mode, as tests/test_torch_bf16.py runs them."""
    mp = pytest.MonkeyPatch()
    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    mp.setattr(gru_pallas, "run_multi_bigru_pallas",
               lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    mp.setattr(scan_pallas, "run_segment_scan_pallas",
               lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    yield
    mp.undo()


def _batch(seed=3, b=2, t=10):
    rng = np.random.default_rng(seed)
    batch = dict(x_human=rng.normal(size=(b, t, 2, 2152)).astype(np.float32),
                 x_objects=rng.normal(size=(b, t, 3, 2048)).astype(np.float32),
                 objects_mask=np.ones((b, 3), np.float32))
    batch["objects_mask"][-1, -1] = 0.0
    seg = (rng.uniform(size=(b, t, 2)) > 0.6).astype(np.float32)
    batch["human_segmentation"] = seg
    batch["steps_per_example"] = np.full((b,), float(t), np.float32)
    carry = {k: rng.uniform(-0.5, 0.5, size=(b, e, 16)).astype(np.float32)
             for k, e in CARRIES.items()}
    objects_segmentation = (rng.uniform(size=(b, t, 3)) > 0.6).astype(np.float32)
    return batch, carry, objects_segmentation


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["v3", "v1"])
def test_carry_matches_jax(interpret, dtype, style):
    kw = dict(KW, attention_style=style, compute_dtype=dtype)
    params = jax_init(jax.random.PRNGKey(0), JaxConfig(**kw))
    batch, carry, objects_segmentation = _batch()
    if dtype == "bfloat16":
        batch["objects_segmentation"] = objects_segmentation
    cfg = JaxConfig(use_pallas_gru=True, use_pallas_segment_scan=True,
                    segment_kernel_modes="all", **kw)
    call = dict(return_carry=True, force_last_step_commit=False, frame_offset=5)
    forward = jax.jit(lambda p, c, x: jax_apply(p, cfg, train=False, rng=jax.random.PRNGKey(7),
                                                 carry=c, **call, **x))
    want, want_aux = forward(params, carry, batch)
    model = select_model("2G-GCN", device="cpu", **kw)
    got, aux = model.apply(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
                           carry={k: torch.as_tensor(v) for k, v in carry.items()},
                           **call, **batch)
    got = [o.numpy() for o in got]
    want = [np.asarray(o) for o in want]
    seqs = [(k, aux["carry_seq"][k].float().numpy(),
             np.asarray(want_aux["carry_seq"][k].astype(jnp.float32)))
            for k in CARRIES]
    assert {k: v.shape for k, v, _ in seqs} == {k: w.shape for k, _, w in seqs}
    if dtype == "float32":
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=f"output {i}")
        for k, g, w in seqs:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=k)
        return
    assert aux["carry_seq"]["seg_human"].dtype == torch.bfloat16
    for i in HEADS:
        assert np.abs(got[i] - want[i]).max() < 1e-2, f"head {i}"
    for k, g, w in seqs:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= 2 * ulp, k


def test_streaming_runner_matches_jax():
    params = jax_init(jax.random.PRNGKey(0), JaxConfig(**KW))
    batch, _, _ = _batch(seed=4, b=1, t=16)
    args = [batch[k] for k in ("x_human", "x_objects", "objects_mask")]
    want = JaxStreamingRunner(params, JaxConfig(**KW), window=4, lookahead=2,
                              fuse_group=1).run(*args)
    model = select_model("2G-GCN", device="cpu", **KW)
    runner = StreamingRunner(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
                             model.config, window=4, lookahead=2)
    got = runner.run(*args)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=f"output {i}")
