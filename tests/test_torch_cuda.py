"""The port's CUDA kernels against their plain versions, on the card.

Run on a host with an NVIDIA Hopper card and nvcc:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Skipped where there is no CUDA device. The kernels build at first use.
Tolerance 1e-5 absolute at these small shapes (float32 sums in another
order than cuBLAS); the backward kernels 1e-5 relative to the largest
gradient of each output (their carries add up over the sequence); a whole
train step on the kernel route against the plain route: losses rtol 1e-5,
each gradient leaf 1e-4 of its largest value (or of a millionth of the
model's largest gradient, where the leaf's gradient is analytically 0). Two
identical train steps on the kernel route give bitwise-equal gradients.
Served requests in every segment mode, kernel route against plain route:
rtol 1e-5, atol 1e-5. The reference fixtures mphoi_st and mphoi_hidden128
on the kernel route: rtol 2e-3, atol 2e-4, as tests/test_golden_tggcn.py
holds the JAX package.

The bfloat16 variants of K1-K4 against their plain bfloat16 versions: the
forward kernels' outputs, and the float32 tensors they keep, within one
bfloat16 ulp at the scale of each tensor's largest value (both carry
float32 state, but a float32 sum in another order can round a state to the
neighbouring bfloat16, and the next step's products read it so); the
backward kernels 1e-2 of each output's largest value (their products take
bfloat16 operands that can round the other way); a bfloat16
train step at hidden 24: losses rtol 1e-2, each gradient leaf 3.9e-2 of its
largest (the worst leaf of the JAX package's bfloat16 kernels against its
XLA route, BASELINE.md), and two identical steps bitwise equal. The stage-2
train step (learned, filtered decisions) at the same limits in each dtype,
with the hard decisions equal on both routes.

K5's bfloat16 variant in each mode against its plain bfloat16 version,
within one bfloat16 ulp of each output's largest value, as K3's; a
bfloat16 request in each segment mode against the plain route within 6e-4
(chip_smoke.py's whole-forward limit); a train step at hidden 24 in each
mode (K5 forward, the recompute backward) in both dtypes, K5 launched
once, the gradients held over the whole model as chip_smoke.py's
train_modes phases hold them (float32 within 1e-4 of the model's largest
gradient; bfloat16 the norm of the difference within 1.15e-2 of the
gradient's), and two identical steps bitwise equal.

K5's scores made once a step ('v1' projections, 'v4' 32-column partial
scores) at the hidden sizes around its 32-column blocks, and K6 at frame
counts around its 12 frames a block and V up to its 32 padded rows, each
against its plain version at the limits above.

Fused train steps at hidden 24 in both dtypes: 3 steps captured once in a
CUDA graph and replayed equal 3 eager kernel-route steps with the same
capturable Adam bit for bit (losses, every leaf, Adam's state), twice in a
row; an eager kernel-route step that draws its own noise makes no
synchronizing call (torch.cuda.set_sync_debug_mode("error")); the fused
steps raise on an Adam they cannot capture and touch no weight.

CAD-120 stage 1 (tggcn_torch.models.cad120) and the general segment scan's
configurations at hidden 24: a request launches exactly K1 (and K6 with
the GeoGCN kernel), no segment-scan kernel, and agrees with the plain route
at rtol 1e-5, atol 1e-5 (bfloat16: 6e-4 absolute); a CAD-120 train step
launches exactly K1 and K2, held to the plain route as the stage-1 step is
in its dtype, two identical steps bitwise equal; 3 fused bfloat16 CAD-120
steps equal 3 eager ones bit for bit, and an eager one makes no
synchronizing call.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from tggcn_torch.ops.geo_gcn import geo_gcn_fused, geo_gcn_fused_autograd, geo_gcn_plain
from tggcn_torch.ops.gru_sequence import (gru_sequence, gru_sequence_bwd,
                                          gru_sequence_bwd_plain, gru_sequence_plain,
                                          previous_states)
from tggcn_torch.ops.segment_scan import (BWD_OUTPUTS, KEPT, previous_states as seg_previous,
                                          segment_scan_att_plain, segment_scan_dot,
                                          segment_scan_dot_bwd, segment_scan_dot_bwd_plain,
                                          segment_scan_dot_plain, segment_scan_ext,
                                          segment_scan_v1, segment_scan_v4)

pytestmark = pytest.mark.cuda
ATOL = 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def read_fixture(path):
    """(inputs, outputs, weights, model kwargs, attention) of a forward
    fixture of tests/golden."""
    data = np.load(path)
    parts = {"input": {}, "output": {}, "weight": {}, "attention": {}}
    for key in data.files:
        kind, _, name = key.partition("::")
        if kind in parts:
            parts[kind][int(name) if kind in ("output", "attention") else name] = data[key]
    kwargs = json.loads(bytes(data["meta::model_kwargs"]).decode())
    ordered = lambda d: [d[i] for i in sorted(d)]
    return (parts["input"], ordered(parts["output"]), parts["weight"], kwargs,
            ordered(parts["attention"]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [8, 24, 132])
def test_gru_sequence_kernel(cuda, h):
    """K1 serving (nothing kept) and training (the gates kept) against its
    plain version; one launch a call."""
    rng = np.random.default_rng(h)
    t, s, r = 9, 4, 20
    args = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rng.normal(size=(t, s, r, 3 * h)), rng.uniform(-0.3, 0.3, size=(s, h, 3 * h)),
        rng.uniform(-0.3, 0.3, size=(s, 3 * h)), rng.normal(size=(s, r, h)))]
    before = gru_sequence.launches
    got = gru_sequence(*args, num_reverse=2)
    got_kept, gates = gru_sequence(*args, num_reverse=2, keep=True)
    assert gru_sequence.launches == before + 2
    want, want_gates = gru_sequence_plain(*args, num_reverse=2, keep=True)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    torch.testing.assert_close(got_kept, want, rtol=0, atol=ATOL)
    torch.testing.assert_close(gates, want_gates, rtol=0, atol=ATOL)


def _close_rel(got, want, what):
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= 1e-5 * scale, f"{what}: {err:.3e} against a largest value of {scale:.3e}"


@pytest.mark.parametrize("h", [8, 24, 132])
def test_gru_sequence_bwd_kernel(cuda, h):
    """K2 from the gates the plain forward kept against its plain version;
    one launch a call."""
    rng = np.random.default_rng(h + 1)
    t, s, r = 9, 4, 20
    gi, w_hh, b_hh, h0, g = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rng.normal(size=(t, s, r, 3 * h)), rng.uniform(-0.3, 0.3, size=(s, h, 3 * h)),
        rng.uniform(-0.3, 0.3, size=(s, 3 * h)), rng.normal(size=(s, r, h)),
        rng.normal(size=(t, s, r, h)))]
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, 2, keep=True)
    hprev = previous_states(out, h0, 2)
    before = gru_sequence_bwd.launches
    got = gru_sequence_bwd(gi, hprev, g, gates, w_hh, num_reverse=2)
    assert gru_sequence_bwd.launches == before + 1
    want = gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse=2)
    for name, g_, w_ in zip(("dgi", "dgh", "dh0"), got, want):
        assert torch.isfinite(g_).all(), name
        _close_rel(g_, w_, name)


@pytest.mark.parametrize("nh,no,h", [(2, 4, 8), (1, 3, 24), (3, 5, 36)])
def test_segment_scan_bwd_kernel(cuda, nh, no, h):
    args = _segment_args(cuda, nh, no, h)
    rng = np.random.default_rng(nh + h)
    t, b = args["gi_h"].shape[1:3]
    out_h, out_o, _, *kept = segment_scan_dot_plain(**args, scale=1 / math.sqrt(h))
    kept = dict(zip(KEPT, kept))
    up = [torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)
          for shape in ((2, t, b, nh, h), (2, t, b, no, h), (2, t, b, nh, no))]
    bwd_args = {k: args[k] for k in ("u_h", "u_o", "w_from", "w_msg_h", "w_msg_o", "w_hh_h",
                                     "w_hh_o")}
    streamed = dict(hprev_h=seg_previous(out_h, args["h0_h"]),
                    hprev_o=seg_previous(out_o, args["h0_o"]),
                    **{k: kept[k] for k in ("m_h", "m_o", "gates_h", "gates_o", "atts")},
                    g_h=up[0], g_o=up[1], g_att=up[2])
    before = segment_scan_dot_bwd.launches
    got = segment_scan_dot_bwd(**bwd_args, **streamed, scale=1 / math.sqrt(h))
    assert segment_scan_dot_bwd.launches == before + 1
    want = segment_scan_dot_bwd_plain(**bwd_args, **streamed, scale=1 / math.sqrt(h))
    for name in BWD_OUTPUTS:
        assert torch.isfinite(got[name]).all(), name
        _close_rel(got[name], want[name], name)


def _segment_args(cuda, nh, no, h, b=5):
    rng = np.random.default_rng(nh * 100 + h + 1000 * (b != 5))
    t = 7
    w = lambda *shape: rng.uniform(-1 / math.sqrt(h), 1 / math.sqrt(h), size=shape)
    mask = (rng.uniform(size=(b, no)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    arrays = dict(
        gi_h=rng.normal(size=(2, t, b, nh, 3 * h)), gi_o=rng.normal(size=(2, t, b, no, 3 * h)),
        u_h=rng.uniform(size=(t, b, nh)) > 0.5, u_o=rng.uniform(size=(t, b, no)) > 0.5,
        w_from=w(4, h, h), b_from=w(4, h), w_msg_h=w(2, 2 * h, 3 * h),
        w_msg_o=w(2, 2 * h, 3 * h), w_hh_h=w(2, h, 3 * h), w_hh_o=w(2, h, 3 * h),
        b_hh_h=w(2, 3 * h), b_hh_o=w(2, 3 * h), obj_mask=mask,
        h0_h=rng.normal(size=(2, b, nh, h)), h0_o=rng.normal(size=(2, b, no, h)))
    return {k: torch.tensor(np.asarray(v, np.float32), device=cuda) for k, v in arrays.items()}


@pytest.mark.parametrize("nh,no,h", [(2, 4, 8), (1, 3, 24), (3, 5, 36)])
def test_segment_scan_kernel(cuda, nh, no, h):
    args = _segment_args(cuda, nh, no, h)
    got = segment_scan_dot(**args, scale=1 / math.sqrt(h))
    want = segment_scan_dot_plain(**args, scale=1 / math.sqrt(h))
    assert len(got) == len(want) == 3 + len(KEPT)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=ATOL)
    served = segment_scan_dot(**args, scale=1 / math.sqrt(h), keep=False)
    assert len(served) == 3
    for g, w_ in zip(served, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=ATOL)


def test_train_step_kernel_route(cuda):
    """One stage-1 train step at hidden 24 on the kernel route (K1-K4 each
    launched once) against the plain route from the same weights and noise."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda, **dict(stage1.MODEL_KWARGS, hidden_size=24))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage1.FEEDER_KWARGS)
    rng = np.random.default_rng(8)
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(
        stage1.make_batch(rng, 2, 6, 2, 3))
    noise = {"object": rng.gumbel(size=(2, 6, 3, 2)).astype(np.float32)}
    wrappers = [gru_sequence, gru_sequence_bwd, segment_scan_dot, segment_scan_dot_bwd]
    results = []
    for use_kernels in (True, False):
        trainable = {"model": model.init(torch.Generator().manual_seed(9))}
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"])
        step = make_train_step(model, feeder, criterion, optimizer, use_kernels=use_kernels)
        before = [w.launches for w in wrappers]
        losses, _, _ = step(trainable, data, targets, noise=noise)
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        assert launched == ([1] * 4 if use_kernels else [0] * 4)
        results.append((losses, [p.grad for p in model_parameters(trainable["model"])]))
    (loss_k, grads_k), (loss_p, grads_p) = results
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_p)
    for g_k, g_p in zip(grads_k, grads_p):
        assert float((g_k - g_p).abs().max()) <= 1e-4 * max(float(g_p.abs().max()), floor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage2_train_step_kernel_route(cuda, dtype):
    """One stage-2 train step at hidden 24 (decisions learned for humans and
    objects, filtered to local maxima at 0.1, the segmentation loss on) on
    the kernel route, K1-K4 each launched once, against the plain route from
    the same weights and the same Gumbel noise for humans and objects; in
    bfloat16 at the bfloat16 limits (losses rtol 1e-2, leaves 3.9e-2)."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage2
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda, **dict(stage2.model_kwargs(dtype),
                                                       hidden_size=24))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage2.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage2.FEEDER_KWARGS)
    rng = np.random.default_rng(12)
    b, t, nh, no = 2, 48, 2, 3
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(
        stage2.make_batch(rng, b, t, nh, no))
    noise = {who: rng.gumbel(size=(b, t, n, 2)).astype(np.float32)
             for who, n in (("human", nh), ("object", no))}
    wrappers = [gru_sequence, gru_sequence_bwd, segment_scan_dot, segment_scan_dot_bwd]
    counter = "launches_bf16" if dtype == "bfloat16" else "launches"
    results = []
    for use_kernels in (True, False):
        trainable = {"model": model.init(torch.Generator().manual_seed(13))}
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage2.TRAIN["lr"])
        step = make_train_step(model, feeder, criterion, optimizer, use_kernels=use_kernels)
        before = [getattr(w, counter) for w in wrappers]
        losses, _, aux = step(trainable, data, targets, noise=noise)
        launched = [getattr(w, counter) - n for w, n in zip(wrappers, before)]
        assert launched == ([1] * 4 if use_kernels else [0] * 4)
        results.append((losses, [p.grad for p in model_parameters(trainable["model"])], aux))
    (loss_k, grads_k, aux_k), (loss_p, grads_p, aux_p) = results
    for who in ("human_decisions", "object_decisions"):
        assert torch.equal(aux_k[who][0], aux_p[who][0]), who
    loss_rtol, leaf_rtol = (1e-2, 3.9e-2) if dtype == "bfloat16" else (1e-5, 1e-4)
    torch.testing.assert_close(loss_k, loss_p, rtol=loss_rtol, atol=0)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_p)
    for g_k, g_p in zip(grads_k, grads_p):
        assert float((g_k - g_p).abs().max()) <= leaf_rtol * max(float(g_p.abs().max()), floor)


MODE_WRAPPERS = {"v1": segment_scan_v1, "v4": segment_scan_v4, "ext": segment_scan_ext}


def _mode_extra(cuda, mode, args, rng):
    t, b, nh = args["gi_h"].shape[1:4]
    no, h = args["gi_o"].shape[3], args["w_hh_h"].shape[1]
    w = lambda *shape: torch.tensor(rng.uniform(-1, 1, size=shape) / math.sqrt(h),
                                    dtype=torch.float32, device=cuda)
    if mode == "v1":
        return dict(w_att=w(4, 2 * h), b_att=w(4))
    if mode == "v4":
        return dict(w_att=w(4, h, h), b_att=w(4))
    e = nh + no
    return dict(att_ext=torch.tensor(rng.uniform(size=(t, b, e, e)), dtype=torch.float32,
                                     device=cuda))


@pytest.mark.parametrize("mode", ["v1", "v4", "ext"])
@pytest.mark.parametrize("nh,no,h", [(2, 4, 8), (1, 3, 24), (3, 5, 36)])
def test_segment_scan_mode_kernel(cuda, mode, nh, no, h):
    """K5 in each mode, with a batch row whose objects are all masked and,
    at (1, 3, 24), one human (an empty h2h row)."""
    args = _segment_args(cuda, nh, no, h)
    extra = _mode_extra(cuda, mode, args, np.random.default_rng(nh + no + h))
    wrapper = MODE_WRAPPERS[mode]
    before = wrapper.launches
    got = wrapper(**args, **extra)
    assert wrapper.launches == before + 1
    want = segment_scan_att_plain(mode, **args, **extra)
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["v1", "v4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("nh,h", [(2, 24), (1, 40), (2, 64), (1, 64)])
def test_segment_scan_mode_scores_at_edge_shapes(cuda, mode, dtype, nh, h):
    """K5's scores made once a step (v1's projections, v4's 32-column
    partial scores: one ragged block at h 24, a ragged last block at 40)
    against the plain version, with a fully masked object row; float32
    within ATOL, bfloat16 within one bfloat16 ulp of each output's largest
    value; the scratch shape the wrapper allocates, and v4's projection
    phase in one wave."""
    from tggcn_torch.ops.segment_scan import scan_occupancy, score_scratch_shape

    args = _segment_args(cuda, nh, 3, h)
    extra = _mode_extra(cuda, mode, args, np.random.default_rng(nh + h))
    args = {k: v.to(dtype) for k, v in args.items()}
    extra = {k: v.to(dtype) for k, v in extra.items()}
    got = MODE_WRAPPERS[mode](**args, **extra)
    want = segment_scan_att_plain(mode, **args, **extra)
    for name, g, w_ in zip(("h_h", "h_o", "att_oh"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w_, rtol=0, atol=ATOL)
        else:
            _bf16_ulp_share(g, w_, name)
    e = nh + 3
    assert score_scratch_shape(mode, args["gi_h"].shape[2], nh, 3, h) == (
        (2, args["gi_h"].shape[2], e, 4) if mode == "v1" else
        (2, args["gi_h"].shape[2], e, e, -(-h // 32)))
    blocks, per_sm, _ = scan_occupancy(mode, dtype, 8, 2, 4, 512)["proj"]
    assert blocks <= per_sm * torch.cuda.get_device_properties(cuda).multi_processor_count


@pytest.mark.parametrize("v", [1, 5, 26, 32])
@pytest.mark.parametrize("n", [1, 11, 13, 37])
def test_geo_gcn_kernel_frames(cuda, n, v):
    """K6 with N frames around its 12 frames a block (and past a block's
    worth) and V up to its 32 padded rows, against the plain version; the
    launch's shape."""
    from tggcn_torch.ops.geo_gcn import FRAMES_PER_BLOCK, geo_gcn_config

    rng = np.random.default_rng(10 * n + v)
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128)]
    weights = [torch.tensor(rng.uniform(-1, 1, size=s) / math.sqrt(s[0]), dtype=torch.float32,
                            device=cuda) for s in shapes]
    x = torch.tensor(rng.normal(size=(n, v, 4)), dtype=torch.float32, device=cuda)
    torch.testing.assert_close(geo_gcn_fused(x, *weights), geo_gcn_plain(x, *weights), rtol=0,
                               atol=ATOL)
    config = geo_gcn_config(n)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert config["frames_per_block"] == FRAMES_PER_BLOCK
    assert config["blocks"] == min(n, sms) and config["blocks_per_sm"] >= 1


@pytest.mark.parametrize("v", [19, 26, 30])
def test_geo_gcn_kernel(cuda, v):
    """K6 against its plain version over N = 37 frames (no multiple of the
    TPU kernel's 16-frame tile), and its gradient against the plain one."""
    rng = np.random.default_rng(v)
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128)]
    weights = [torch.tensor(rng.uniform(-1, 1, size=s) / math.sqrt(s[0]), dtype=torch.float32,
                            device=cuda) for s in shapes]
    x = torch.tensor(rng.normal(size=(37, v, 4)), dtype=torch.float32, device=cuda)
    before = geo_gcn_fused.launches
    got = geo_gcn_fused(x, *weights)
    assert geo_gcn_fused.launches == before + 1
    torch.testing.assert_close(got, geo_gcn_plain(x, *weights), rtol=0, atol=ATOL)
    leaves = [t.clone().requires_grad_(True) for t in (x, *weights)]
    g = torch.tensor(rng.normal(size=got.shape), dtype=torch.float32, device=cuda)
    grads = torch.autograd.grad(geo_gcn_fused_autograd(*leaves), leaves, g)
    want = torch.autograd.grad(geo_gcn_plain(*leaves), leaves, g)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant", ["dist", "v1", "v4", "mp"])
def test_serve_modes_kernel_route(cuda, variant):
    """A served request at hidden 24 in each segment mode: the kernel route
    (K1, K5 in the mode and, for 'dist', K6) against the plain route on the
    card from the same weights and noise; the plain route launches nothing."""
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model

    model = select_model("2G-GCN", device=cuda, **dict(stage1.MODEL_KWARGS, hidden_size=24,
                                                       **stage1.SERVE_VARIANTS[variant]))
    params = model.init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    batch = stage1.make_request(rng, 2, 7, 2, 3)
    if variant == "dist":
        batch.update(stage1.make_distances(rng, 2, 7, 2, 3))
    noise = {"object": rng.gumbel(size=(2, 7, 3, 2)).astype(np.float32)}
    wrappers = [gru_sequence, MODE_WRAPPERS["ext" if variant in ("dist", "mp") else variant],
                geo_gcn_fused]
    before = [w.launches for w in wrappers]
    got, _ = model.apply(params, noise=noise, **batch)
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched == [1, 1, 1 if variant == "dist" else 0]
    want, _ = model.apply(params, use_kernels=False, noise=noise, **batch)
    assert [w.launches for w in wrappers] == [b + n for b, n in zip(before, launched)]
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


def test_train_step_gradients_are_reproducible(cuda):
    """Two stage-1 train steps on the kernel route from the same weights,
    batch and noise give bitwise-equal gradients on every leaf."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda, **dict(stage1.MODEL_KWARGS, hidden_size=24))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage1.FEEDER_KWARGS)
    rng = np.random.default_rng(10)
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(
        stage1.make_batch(rng, 3, 9, 2, 4))
    noise = {"object": rng.gumbel(size=(3, 9, 4, 2)).astype(np.float32)}
    grads = []
    for _ in range(2):
        trainable = {"model": model.init(torch.Generator().manual_seed(11))}
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"])
        make_train_step(model, feeder, criterion, optimizer)(trainable, data, targets,
                                                             noise=noise)
        grads.append([p.grad.clone() for p in model_parameters(trainable["model"])])
    assert len(grads[0]) == len(grads[1]) > 0
    unequal = [i for i, (a, b) in enumerate(zip(*grads)) if not torch.equal(a, b)]
    assert not unequal, f"leaves {unequal} of {len(grads[0])} differ between two runs"


@pytest.mark.parametrize("name", ["mphoi_st", "mphoi_hidden128"])
def test_golden_fixture_kernel_route(cuda, name):
    """A reference fixture through the port's state-dict loader, served on
    the kernel route (K1 and K3)."""
    from tggcn_torch.compat.weights import tggcn_params_from_torch_state_dict
    from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn

    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this copy of the repository")
    inputs, ref_outputs, weights, kwargs, ref_attention = read_fixture(path)
    cfg = TGGCNConfig.from_kwargs(**kwargs)
    params = tggcn_params_from_torch_state_dict(weights, cfg)
    params = _to_device(params, cuda)
    before = gru_sequence.launches, segment_scan_dot.launches
    with torch.no_grad():
        outputs, aux = apply_tggcn(params, cfg, inspect_model=True,
                                   **{k: torch.tensor(v, device=cuda) for k, v in inputs.items()})
    assert (gru_sequence.launches, segment_scan_dot.launches) == tuple(n + 1 for n in before)
    assert len(outputs) == len(ref_outputs)
    for i, (got, want) in enumerate(zip(outputs, ref_outputs)):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"output {i}")
    for i, (got, want) in enumerate(zip(aux["attention_scores"], ref_attention)):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"attention {i}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


BF16 = torch.bfloat16


def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _within_one_ulp(got, want, what):
    """|got - want| within one bfloat16 ulp of want's largest value."""
    assert got.dtype == want.dtype, what
    err = float((got.float() - want.float()).abs().max())
    limit = bf16_ulp(float(want.float().abs().max()))
    assert err <= limit, f"{what}: {err:.3e} (limit {limit:.3e})"


def _close_share(got, want, what, share):
    scale = float(want.float().abs().max()) or 1.0
    err = float((got.float() - want.float()).abs().max())
    assert err <= share * scale, f"{what}: {err:.3e} against a largest value of {scale:.3e}"


# The bfloat16 K1/K2 plan's edges: h from one block (8, 24) to a cluster of
# 2, 5 (a ragged last block) and 16 blocks, R from one row to more than one
# 32-row tile, with and without reversed streams.
GRU_BF16_H = [8, 24, 64, 136, 512]
GRU_BF16_R = [1, 20, 33]


def _gru_args_bf16(cuda, seed, t, s, r, h):
    rng = np.random.default_rng(seed)
    return [torch.tensor(a, dtype=BF16, device=cuda) for a in (
        rng.normal(size=(t, s, r, 3 * h)), rng.uniform(-0.3, 0.3, size=(s, h, 3 * h)),
        rng.uniform(-0.3, 0.3, size=(s, 3 * h)), rng.normal(size=(s, r, h)))]


@pytest.mark.parametrize("nr", [0, 2])
@pytest.mark.parametrize("r", GRU_BF16_R)
@pytest.mark.parametrize("h", GRU_BF16_H)
def test_gru_sequence_kernel_bf16(cuda, h, r, nr):
    """K1 in bfloat16, serving and training, against its plain version, with
    a nonzero h0 through the state slot; a call repeated bit for bit; one
    launch counted a call."""
    t, s = 9, 4
    args = _gru_args_bf16(cuda, h + 50 + r + nr, t, s, r, h)
    before = gru_sequence.launches, gru_sequence.launches_bf16
    got = gru_sequence(*args, num_reverse=nr)
    got_kept, gates = gru_sequence(*args, num_reverse=nr, keep=True)
    assert (gru_sequence.launches, gru_sequence.launches_bf16) == (before[0], before[1] + 2)
    again, gates_again = gru_sequence(*args, num_reverse=nr, keep=True)
    assert torch.equal(again, got_kept) and torch.equal(gates_again, gates)
    want, want_gates = gru_sequence_plain(*args, num_reverse=nr, keep=True)
    assert got.dtype == BF16 and gates.dtype == torch.float32
    _within_one_ulp(got, want, "states")
    _within_one_ulp(got_kept, want, "states (keep)")
    _within_one_ulp(gates, want_gates, "gates")


@pytest.mark.parametrize("nr", [0, 2])
@pytest.mark.parametrize("r", GRU_BF16_R)
@pytest.mark.parametrize("h", GRU_BF16_H)
def test_gru_sequence_bwd_kernel_bf16(cuda, h, r, nr):
    """K2 in bfloat16 from the gates the plain forward kept, from a nonzero
    h0; a call repeated bit for bit; one launch counted a call."""
    t, s = 9, 4
    gi, w_hh, b_hh, h0 = _gru_args_bf16(cuda, h + 51 + r + nr, t, s, r, h)
    g = torch.tensor(np.random.default_rng(h + r).normal(size=(t, s, r, h)), dtype=BF16,
                     device=cuda)
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, nr, keep=True)
    hprev = previous_states(out, h0, nr)
    before = gru_sequence_bwd.launches_bf16
    got = gru_sequence_bwd(gi, hprev, g, gates, w_hh, num_reverse=nr)
    assert gru_sequence_bwd.launches_bf16 == before + 1
    again = gru_sequence_bwd(gi, hprev, g, gates, w_hh, num_reverse=nr)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    want = gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse=nr)
    for name, g_, w_ in zip(("dgi", "dgh", "dh0"), got, want):
        assert g_.dtype == BF16 and torch.isfinite(g_).all(), name
        _close_share(g_, w_, name, 1e-2)


def _gru_kernel_launches(fn):
    """{kernel name: launches} of one call of fn on the card (profiler)."""
    from tggcn_torch.profile_scan import device_ms_by_kernel

    return {k: v["launches"] for k, v in device_ms_by_kernel(fn, 1).items()}


@pytest.mark.parametrize("h,cluster", [(512, 16), (136, 5), (520, 0)])
def test_gru_bf16_route_by_shape(cuda, h, cluster):
    """The bfloat16 route is chosen from the shape: at h <= 512 one cluster
    launch a call for K1 and for K2 (gru_plan's cluster of ceil(h / 32)
    blocks, which the card holds at once); at h = 520 the per-step kernels,
    T launches for K1 and T + 1 for K2, within the same tolerances."""
    from tggcn_torch.ops.gru_sequence import gru_plan

    t, s, r, nr = 7, 2, 20, 1
    gi, w_hh, b_hh, h0 = _gru_args_bf16(cuda, h, t, s, r, h)
    for kind in ("fwd", "bwd"):
        plan = gru_plan(kind, s, r, h)
        assert plan["cluster"] == cluster and plan["units"] == 32 and plan["rows"] == 20
        if cluster:
            assert plan["co_resident"] >= 1 and plan["smem"] <= 227 * 1024
    fwd = _gru_kernel_launches(lambda: gru_sequence(gi, w_hh, b_hh, h0, nr, keep=True))
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, nr, keep=True)
    g = torch.ones_like(out)
    bwd = _gru_kernel_launches(
        lambda: gru_sequence_bwd(gi, previous_states(out, h0, nr), g, gates, w_hh, nr))
    if cluster:
        assert fwd.get("gru_cluster_kernel") == 1 and bwd.get("gru_bwd_cluster") == 1, (fwd, bwd)
    else:
        assert fwd.get("gru_step_kernel") == t and "gru_cluster_kernel" not in fwd, fwd
        assert bwd.get("gru_bwd_carry") == t and bwd.get("gru_bwd_first") == 1, bwd
    got, got_gates = gru_sequence(gi, w_hh, b_hh, h0, nr, keep=True)
    _within_one_ulp(got, out, "states")
    _within_one_ulp(got_gates, gates, "gates")


def test_gru_bf16_kernels_capture_in_a_graph(cuda):
    """K1 and K2 in bfloat16 (the cluster route) captured in a CUDA graph and
    replayed give the bits of the eager calls."""
    t, s, r, h, nr = 9, 4, 20, 64, 2
    gi, w_hh, b_hh, h0 = _gru_args_bf16(cuda, 7, t, s, r, h)
    g = torch.tensor(np.random.default_rng(8).normal(size=(t, s, r, h)), dtype=BF16,
                     device=cuda)

    def both():
        out, gates = gru_sequence(gi, w_hh, b_hh, h0, nr, keep=True)
        return (out, gates) + gru_sequence_bwd(gi, previous_states(out, h0, nr), g, gates,
                                               w_hh, nr)

    eager = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "gates", "dgi", "dgh", "dh0"), captured, eager):
        assert torch.equal(a, b), name


def _segment_args_bf16(cuda, nh, no, h, b=5):
    return {k: v.to(BF16) for k, v in _segment_args(cuda, nh, no, h, b).items()}


# The bfloat16 scan's shapes (humans, objects, h, B): ragged widths at B=5,
# MPHOI's full width at its batch of 8, and a streamed window's batch of 1.
SCAN_SHAPES_BF16 = [pytest.param(2, 4, 8, 5, id="2-4-8"), pytest.param(1, 3, 24, 5, id="1-3-24"),
                    pytest.param(3, 5, 40, 5, id="3-5-40"),
                    pytest.param(2, 4, 512, 8, id="2-4-512-b8"),
                    pytest.param(2, 4, 40, 1, id="2-4-40-b1")]


@pytest.mark.parametrize("nh,no,h,b", SCAN_SHAPES_BF16)
def test_segment_scan_kernel_bf16(cuda, nh, no, h, b):
    """K3 in bfloat16, training and serving, against its plain version."""
    args = _segment_args_bf16(cuda, nh, no, h, b)
    before = segment_scan_dot.launches_bf16
    got = segment_scan_dot(**args, scale=1 / math.sqrt(h))
    served = segment_scan_dot(**args, scale=1 / math.sqrt(h), keep=False)
    assert segment_scan_dot.launches_bf16 == before + 2
    want = segment_scan_dot_plain(**args, scale=1 / math.sqrt(h))
    names = ("h_h", "h_o", "att_oh") + KEPT
    for name, g, w_ in zip(names, got, want):
        _within_one_ulp(g, w_, name)
    for name, g, w_ in zip(names, served, want[:3]):
        _within_one_ulp(g, w_, f"{name} (serving)")


# K4's bfloat16 shapes: the scan's, MPHOI's full width at a data-parallel
# process's batch of 4 and a streamed window's 1, a batch of 9 whose
# object rows need two batch tiles of a DA cluster (8 clips of 4 objects
# in 32 rows), h = 136 (a ragged last 32-column block and 16-unit tile),
# and h = 520, past the cluster route (the per-step kernels).
BWD_SHAPES_BF16 = SCAN_SHAPES_BF16 + [
    pytest.param(2, 4, 512, 4, id="2-4-512-b4"), pytest.param(2, 4, 512, 1, id="2-4-512-b1"),
    pytest.param(2, 4, 40, 9, id="2-4-40-b9"), pytest.param(1, 3, 136, 3, id="1-3-136-b3"),
    pytest.param(2, 4, 520, 2, id="2-4-520-b2")]


def _bwd_args_bf16(cuda, nh, no, h, b):
    """K4's bfloat16 inputs from what the plain forward kept."""
    args = _segment_args_bf16(cuda, nh, no, h, b)
    rng = np.random.default_rng(nh + h + 52)
    t = args["gi_h"].shape[1]
    out_h, out_o, _, *kept = segment_scan_dot_plain(**args, scale=1 / math.sqrt(h))
    kept = dict(zip(KEPT, kept))
    up = [torch.tensor(rng.normal(size=shape), dtype=BF16, device=cuda)
          for shape in ((2, t, b, nh, h), (2, t, b, no, h), (2, t, b, nh, no))]
    bwd_args = {k: args[k] for k in ("u_h", "u_o", "w_from", "w_msg_h", "w_msg_o", "w_hh_h",
                                     "w_hh_o")}
    return dict(hprev_h=seg_previous(out_h, args["h0_h"]),
                hprev_o=seg_previous(out_o, args["h0_o"]),
                **{k: kept[k] for k in ("m_h", "m_o", "gates_h", "gates_o", "atts")},
                g_h=up[0], g_o=up[1], g_att=up[2], **bwd_args)


@pytest.mark.parametrize("nh,no,h,b", BWD_SHAPES_BF16)
def test_segment_scan_bwd_kernel_bf16(cuda, nh, no, h, b):
    """K4 in bfloat16 from what the plain forward kept, against its plain
    version; on the cluster route (h <= 512) also bit for bit the per-step
    route's outputs, and the same bits on a repeat."""
    args = _bwd_args_bf16(cuda, nh, no, h, b)
    scale = 1 / math.sqrt(h)
    before = segment_scan_dot_bwd.launches_bf16
    got = segment_scan_dot_bwd(**args, scale=scale)
    assert segment_scan_dot_bwd.launches_bf16 == before + 1
    want = segment_scan_dot_bwd_plain(**args, scale=scale)
    for name in BWD_OUTPUTS:
        assert got[name].dtype == BF16 and torch.isfinite(got[name]).all(), name
        _close_share(got[name], want[name], name, 1e-2)
    again = segment_scan_dot_bwd(**args, scale=scale)
    steps = segment_scan_dot_bwd(**args, scale=scale, route="steps")
    for name in BWD_OUTPUTS:
        assert torch.equal(again[name], got[name]), f"{name}: a repeat differs"
        assert torch.equal(steps[name], got[name]), f"{name}: the routes differ"


def _bwd_kernel_launches(args, h, route=None, calls=10):
    """{kernel name: launches a call} of K4's wrapper, counted by the
    profiler over `calls` calls and rounded (a profiler window can miss the
    first kernels of its first call)."""
    from tggcn_torch.profile_scan import device_ms_by_kernel

    fn = lambda: segment_scan_dot_bwd(**args, scale=1 / math.sqrt(h), route=route)
    return {k: round(v["launches"]) for k, v in device_ms_by_kernel(fn, calls).items()}


@pytest.mark.parametrize("nh,no,h,b,cluster", [(2, 4, 512, 8, True), (2, 4, 40, 9, True),
                                               (1, 3, 136, 3, True), (2, 4, 520, 2, False)])
def test_segment_scan_bwd_bf16_route_by_shape(cuda, nh, no, h, b, cluster):
    """K4's bfloat16 route follows the shape (bwd_plan): at h <= 512 two
    launches a step, DA (segb_dmsgs_att, clusters of ceil(h / 32) blocks,
    at least one of which the card holds at once) and R (segb_carry_ds),
    and no segb_att, 2T + 2 launches a call; at h = 520 the per-step
    kernels, 3T + 2. The float32 kernel takes the per-step route at every
    shape."""
    from tggcn_torch.ops.segment_scan import bwd_plan

    args = _bwd_args_bf16(cuda, nh, no, h, b)
    t = args["hprev_h"].shape[1]
    plan = bwd_plan(b, nh, no, h)
    assert plan["route"] == int(cluster), plan
    got = _bwd_kernel_launches(args, h)
    if cluster:
        assert plan["da_blocks"] == -(-h // 32) and plan["batch_tile"] == 32 // max(nh, no)
        assert plan["da_co_resident"] >= 1 and plan["da_smem"] <= 227 * 1024, plan
        want = {"segb_cell": 1, "segb_dmsgs_att": t, "segb_carry_ds": t, "du_sum": 1}
    else:
        want = {"segb_cell": 1, "segb_dmsgs": t, "segb_att": t, "segb_carry": t, "du_sum": 1}
    assert {k: v for k, v in got.items() if k.startswith(("segb_", "du_sum"))} == want, got
    assert sum(want.values()) == (2 if cluster else 3) * t + 2
    steps = _bwd_kernel_launches(args, h, route="steps")
    assert steps.get("segb_att") == t and "segb_carry_ds" not in steps, steps
    f32 = {k: v.float() if v.dtype == BF16 else v for k, v in args.items()}
    plain = _bwd_kernel_launches(f32, h)
    assert plain.get("segb_att") == t and "segb_dmsgs_att" not in plain, plain


def test_segment_scan_bwd_float32_route_unchanged(cuda):
    """Float32 K4 keeps the per-step kernels at the MPHOI width: route
    'steps' is its only route (the same bits), 'cluster' raises, and it
    holds the plain version at the float32 limit."""
    args = {k: v.float() if v.dtype == BF16 else v
            for k, v in _bwd_args_bf16(cuda, 2, 4, 512, 2).items()}
    scale = 1 / math.sqrt(512)
    got = segment_scan_dot_bwd(**args, scale=scale)
    steps = segment_scan_dot_bwd(**args, scale=scale, route="steps")
    want = segment_scan_dot_bwd_plain(**args, scale=scale)
    for name in BWD_OUTPUTS:
        assert got[name].dtype == torch.float32 and torch.equal(steps[name], got[name]), name
        _close_rel(got[name], want[name], name)
    with pytest.raises(ValueError, match="bfloat16"):
        segment_scan_dot_bwd(**args, scale=scale, route="cluster")


def test_segment_scan_bwd_bf16_captures_in_a_graph(cuda):
    """K4's bfloat16 two-launch route (a cluster launch a step) captured in a
    CUDA graph and replayed gives the bits of the eager call."""
    args = _bwd_args_bf16(cuda, 2, 4, 64, 3)
    scale = 1 / math.sqrt(64)
    eager = segment_scan_dot_bwd(**args, scale=scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        segment_scan_dot_bwd(**args, scale=scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = segment_scan_dot_bwd(**args, scale=scale)
    graph.replay()
    torch.cuda.synchronize()
    for name in BWD_OUTPUTS:
        assert torch.equal(captured[name], eager[name]), name


# (B, humans, objects, h) of every call the bfloat16 scan meets: MPHOI's
# train step, a data-parallel half, streamed windows of 1, 2 and 4 clips,
# entry_mphoi's predict batch, and the card cases above.
LAUNCH_SHAPES_BF16 = {"mphoi": (8, 2, 4, 512), "dp_half": (4, 2, 4, 512),
                      "stream_b1": (1, 2, 4, 512), "stream_b2": (2, 2, 4, 512),
                      "predict_b128": (128, 2, 4, 512), "card_2_4_8": (5, 2, 4, 8),
                      "card_1_3_24": (5, 1, 3, 24), "card_3_5_40": (5, 3, 5, 40),
                      "card_b1": (1, 2, 4, 40)}


@pytest.mark.parametrize("shape", list(LAUNCH_SHAPES_BF16))
def test_segment_scan_bf16_launch_shapes(cuda, shape):
    """K3's bfloat16 product phases (proj_wg and cell_wg, wgmma fed by TMA)
    launch the float32 phases' grids, within a block's 227 KB of shared
    memory and at least one block an SM, as the library's occupancy query
    reports them; their rings of at most 8 stages fit two blocks an SM at
    h = 512."""
    from tggcn_torch.ops.segment_scan import scan_occupancy

    b, nh, no, h = LAUNCH_SHAPES_BF16[shape]
    got = scan_occupancy("dot", BF16, b, nh, no, h)
    want = scan_occupancy("dot", torch.float32, b, nh, no, h)
    for phase in ("proj", "cell"):
        blocks, per_sm, smem = got[phase]
        assert blocks == want[phase][0], phase
        assert per_sm >= 1 and smem <= 227 * 1024, (phase, per_sm, smem)
        if h == 512:
            assert per_sm >= 2, (phase, per_sm, smem)


def _bf16_train_steps(cuda, use_kernels_list, seed):
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda,
                         **dict(stage1.model_kwargs("bfloat16"), hidden_size=24))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage1.FEEDER_KWARGS)
    rng = np.random.default_rng(seed)
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(
        stage1.make_batch(rng, 2, 8, 2, 3))
    noise = {"object": rng.gumbel(size=(2, 8, 3, 2)).astype(np.float32)}
    wrappers = [gru_sequence, gru_sequence_bwd, segment_scan_dot, segment_scan_dot_bwd]
    results = []
    for use_kernels in use_kernels_list:
        trainable = {"model": model.init(torch.Generator().manual_seed(seed + 1))}
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"])
        step = make_train_step(model, feeder, criterion, optimizer, use_kernels=use_kernels)
        before = [w.launches_bf16 for w in wrappers]
        losses, _, _ = step(trainable, data, targets, noise=noise)
        launched = [w.launches_bf16 - b for w, b in zip(wrappers, before)]
        assert launched == ([1] * 4 if use_kernels else [0] * 4)
        grads = [p.grad for p in model_parameters(trainable["model"])]
        assert all(g.dtype == torch.float32 for g in grads)
        results.append((losses, grads))
    return results


def test_train_step_kernel_route_bf16(cuda):
    """One bfloat16 train step at hidden 24 on the kernel route (K1-K4 in
    bfloat16, each launched once) against the plain route."""
    (loss_k, grads_k), (loss_p, grads_p) = _bf16_train_steps(cuda, (True, False), 12)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-2, atol=0)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_p)
    for g_k, g_p in zip(grads_k, grads_p):
        assert float((g_k - g_p).abs().max()) <= 3.9e-2 * max(float(g_p.abs().max()), floor)


def test_train_step_gradients_are_reproducible_bf16(cuda):
    """Two identical bfloat16 train steps on the kernel route give
    bitwise-equal gradients on every leaf."""
    (_, first), (_, second) = _bf16_train_steps(cuda, (True, True), 14)
    unequal = [i for i, (a, b) in enumerate(zip(first, second)) if not torch.equal(a, b)]
    assert not unequal, f"leaves {unequal} of {len(first)} differ between two runs"


def _bf16_ulp_share(got, want, what):
    """got within one bfloat16 ulp at the scale of want's largest value."""
    top = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    err = float((got.float() - want.float()).abs().max())
    assert err <= ulp, f"{what}: {err:.3e} against a largest value of {top:.3e}"


@pytest.mark.parametrize("mode", ["v1", "v4", "ext"])
@pytest.mark.parametrize("nh,no,h", [(2, 4, 8), (1, 3, 24), (3, 5, 40)])
def test_segment_scan_mode_kernel_bf16(cuda, mode, nh, no, h):
    """K5's bfloat16 variant in each mode (h % 8 == 0), counted apart."""
    args = _segment_args_bf16(cuda, nh, no, h)
    extra = {k: v.to(BF16) for k, v in _mode_extra(
        cuda, mode, {k: v.float() for k, v in args.items()},
        np.random.default_rng(nh + no + h)).items()}
    wrapper = MODE_WRAPPERS[mode]
    before = (wrapper.launches, wrapper.launches_bf16)
    got = wrapper(**args, **extra)
    assert (wrapper.launches, wrapper.launches_bf16) == (before[0], before[1] + 1)
    want = segment_scan_att_plain(mode, **args, **extra)
    for name, g, w_ in zip(("h_h", "h_o", "att_oh"), got, want):
        assert g.dtype == BF16 and bool(torch.isfinite(g.float()).all()), name
        _bf16_ulp_share(g, w_, name)


def _mode_train_steps(cuda, variant, dtype, use_kernels_list, seed):
    """Train steps at hidden 24 in a serving variant, one per entry of
    use_kernels_list from the same weights: (losses, gradients) each."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda, **dict(
        stage1.model_kwargs(dtype), hidden_size=24, **stage1.SERVE_VARIANTS[variant]))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage1.feeder_kwargs(variant))
    rng = np.random.default_rng(seed)
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(
        stage1.make_batch(rng, 2, 8, 2, 3, variant=variant))
    noise = {"object": rng.gumbel(size=(2, 8, 3, 2)).astype(np.float32)}
    wrapper = MODE_WRAPPERS["ext" if variant in ("dist", "mp") else variant]
    attr = "launches_bf16" if dtype == "bfloat16" else "launches"
    results = []
    for use_kernels in use_kernels_list:
        trainable = {"model": model.init(torch.Generator().manual_seed(seed + 1))}
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"])
        step = make_train_step(model, feeder, criterion, optimizer, use_kernels=use_kernels)
        before = getattr(wrapper, attr)
        losses, _, _ = step(trainable, data, targets, noise=noise)
        assert getattr(wrapper, attr) == before + int(use_kernels)
        results.append((losses, [p.grad for p in model_parameters(trainable["model"])]))
    return results


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["dist", "v1", "v4", "mp"])
def test_mode_train_step_kernel_route(cuda, variant, dtype):
    """A train step in each segment mode: K5 forward (once), the gradients
    from the recompute of the fast path at each route's own saved inputs;
    kernel route against plain route (losses rtol 1e-5 in float32, 1e-2
    in bfloat16; the gradients over the whole model: a recomputed ReLU
    score within rounding of its kink may flip, which moves a small leaf by
    a large share of itself), then two kernel-route steps bitwise equal."""
    (loss_k, grads_k), (loss_p, grads_p), (_, again) = _mode_train_steps(
        cuda, variant, dtype, (True, False, True), 21)
    bf16 = dtype == "bfloat16"
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-2 if bf16 else 1e-5, atol=0)
    diff = torch.cat([(g_k - g_p).double().flatten() for g_k, g_p in zip(grads_k, grads_p)])
    want = torch.cat([g_p.double().flatten() for g_p in grads_p])
    if bf16:
        assert float(diff.norm() / want.norm()) <= 1.15e-2
    else:
        assert float(diff.abs().max() / want.abs().max()) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(grads_k, again))


@pytest.mark.parametrize("variant", ["dist", "v1", "v4", "mp"])
def test_serve_modes_kernel_route_bf16(cuda, variant):
    """A bfloat16 request at hidden 24 in each segment mode: K1's and K5's
    bfloat16 variants and, for 'dist', K6 in float32."""
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model

    model = select_model("2G-GCN", device=cuda, **dict(
        stage1.model_kwargs("bfloat16"), hidden_size=24, **stage1.SERVE_VARIANTS[variant]))
    params = model.init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    batch = stage1.make_request(rng, 2, 7, 2, 3)
    if variant == "dist":
        batch.update(stage1.make_distances(rng, 2, 7, 2, 3))
    # The objects' segmentation imposed too: a bfloat16 soft decision within
    # an ulp of the threshold may round either way on the two routes.
    batch["objects_segmentation"] = (rng.uniform(size=(2, 7, 3)) < 0.5).astype(np.float32)
    noise = {"object": rng.gumbel(size=(2, 7, 3, 2)).astype(np.float32)}
    counters = [(gru_sequence, "launches_bf16"),
                (MODE_WRAPPERS["ext" if variant in ("dist", "mp") else variant], "launches_bf16"),
                (geo_gcn_fused, "launches")]
    before = [getattr(w, a) for w, a in counters]
    got, _ = model.apply(params, noise=noise, **batch)
    launched = [getattr(w, a) - b for (w, a), b in zip(counters, before)]
    assert launched == [1, 1, 1 if variant == "dist" else 0]
    want, _ = model.apply(params, use_kernels=False, noise=noise, **batch)
    for g, w_ in zip(got, want):
        assert float((g - w_).abs().max()) <= 6e-4


def _fused_setup(cuda, dtype, hidden=24, k=3):
    """A stage-1 model at hidden, its loss bundle and feeder, a seeded batch
    on the card, its K-step stacks and a noise stack of K steps."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.loop import gumbel_noise_stack
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda, **dict(stage1.model_kwargs(dtype),
                                                       hidden_size=hidden))
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", stage1.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **stage1.FEEDER_KWARGS)
    data, targets = select_model_data_fetcher("2G-GCN", "multiple", dataset_name="mphoi")(
        stage1.make_batch(np.random.default_rng(31), 2, 6, 2, 3))
    data = [torch.as_tensor(x, device=cuda) for x in data]
    targets = [torch.as_tensor(y, device=cuda) for y in targets]
    noise = gumbel_noise_stack(torch.Generator(device=cuda).manual_seed(32), k, 2, 6, 2, 3)
    return model, criterion, feeder, data, targets, noise


def _adam(trainable, capturable=True):
    from tggcn_torch.models import stage1
    from tggcn_torch.train.loop import trainable_parameters

    return torch.optim.Adam(trainable_parameters(trainable), lr=stage1.TRAIN["lr"],
                            capturable=capturable)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_steps_replay_equals_eager_steps(cuda, dtype):
    """K=3 steps captured once in a CUDA graph and replayed, at hidden 24,
    equal 3 eager kernel-route steps with the same capturable Adam, weights,
    batch and noise bit for bit: the losses, every leaf, Adam's moments and
    step counts, the BatchNorm state; a second call replays the same graph."""
    from tggcn_torch.train.loop import make_fused_train_steps, make_train_step

    model, criterion, feeder, data, targets, noise = _fused_setup(cuda, dtype)
    k = noise["object"].shape[0]
    eager = {"model": model.init(torch.Generator().manual_seed(33))}
    eager_opt = _adam(eager)
    step = make_train_step(model, feeder, criterion, eager_opt)
    want = torch.stack([step(eager, data, targets, noise={w: v[i] for w, v in noise.items()})[0]
                        for i in range(k)])
    fused_tree = {"model": model.init(torch.Generator().manual_seed(33))}
    fused_opt = _adam(fused_tree)
    fused = make_fused_train_steps(model, feeder, criterion, fused_opt)
    stacks = [[x.expand(k, *x.shape) for x in xs] for xs in (data, targets)]
    got, _ = fused(fused_tree, *stacks, noise_stack=noise)
    assert torch.equal(got, want)
    leaves = lambda tree: [x for _, x in _flat_leaves(tree)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(fused_tree), leaves(eager)))
    for p, q in zip(fused_opt.param_groups[0]["params"], eager_opt.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fused_opt.state[p][key], eager_opt.state[q][key]), key
    again, _ = fused(fused_tree, *stacks, noise_stack=noise)
    want = torch.stack([step(eager, data, targets, noise={w: v[i] for w, v in noise.items()})[0]
                        for i in range(k)])
    assert torch.equal(again, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(fused_tree), leaves(eager)))


def _flat_leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flat_leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flat_leaves(sub, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_kernel_route_step_never_syncs(cuda, dtype):
    """An eager stage-1 kernel-route step that draws its own Gumbel noise
    on the card makes no synchronizing call (torch's sync debug mode set
    to raise), after a warm-up step that builds the kernels."""
    from tggcn_torch.train.loop import make_train_step

    model, criterion, feeder, data, targets, _ = _fused_setup(cuda, dtype)
    trainable = {"model": model.init(torch.Generator().manual_seed(34))}
    step = make_train_step(model, feeder, criterion, _adam(trainable, capturable=False))
    gen = torch.Generator(device=cuda).manual_seed(35)
    step(trainable, data, targets, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, _, _ = step(trainable, data, targets, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(losses.isfinite().all())


def test_fused_steps_refuse_an_optimizer_they_cannot_capture(cuda):
    """On the card the fused steps raise on an Adam whose step count lives
    on the host, before any step runs, instead of looping eagerly."""
    from tggcn_torch.train.loop import make_fused_train_steps

    model, criterion, feeder, data, targets, noise = _fused_setup(cuda, "float32")
    trainable = {"model": model.init(torch.Generator().manual_seed(36))}
    before = [x.clone() for _, x in _flat_leaves(trainable)]
    fused = make_fused_train_steps(model, feeder, criterion, _adam(trainable, capturable=False))
    k = noise["object"].shape[0]
    with pytest.raises(ValueError, match="capturable"):
        fused(trainable, [x.expand(k, *x.shape) for x in data],
              [y.expand(k, *y.shape) for y in targets], noise_stack=noise)
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, _flat_leaves(trainable)))


# --- CAD-120 stage 1 and the general segment scan ----------------------------------

def _cad120_setup(cuda, dtype, variant=None, hidden=24, b=3, t=9):
    """The CAD-120 model at hidden, its 12-loss bundle and feeder, and a
    seeded batch on the card (1 human, 5 object slots, some empty)."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import cad120
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.losses import select_loss

    model = select_model("2G-GCN", device=cuda, **dict(
        cad120.model_kwargs(dtype), hidden_size=hidden,
        **(cad120.SERVE_VARIANTS[variant] if variant else {})))
    criterion, _ = select_loss("2G-GCN", "multiple", cad120.DATASET, cad120.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **cad120.feeder_kwargs(variant))
    data, targets = select_model_data_fetcher("2G-GCN", "multiple",
                                              dataset_name=cad120.DATASET)(
        cad120.make_batch(np.random.default_rng(41), b, t, 1, 5, variant=variant))
    data = [torch.as_tensor(x, device=cuda) for x in data]
    targets = [torch.as_tensor(y, device=cuda) for y in targets]
    return model, criterion, feeder, data, targets


def _launch_counts(bf16):
    attr = "launches_bf16" if bf16 else "launches"
    counters = [getattr(w, attr) for w in (gru_sequence, gru_sequence_bwd, segment_scan_dot,
                                           segment_scan_dot_bwd, segment_scan_v1,
                                           segment_scan_v4, segment_scan_ext)]
    return counters + [geo_gcn_fused.launches]


@pytest.mark.parametrize("dtype,variant", [("float32", None), ("bfloat16", None),
                                           ("float32", "dist")])
def test_cad120_request_kernel_route(cuda, dtype, variant):
    """A CAD-120 request at hidden 24: its segment scan is the general one,
    so the kernel route launches exactly K1 (and K6 with the GeoGCN kernel
    on), once; against the plain route at rtol 1e-5, atol 1e-5 (bfloat16:
    6e-4 absolute, chip_smoke.py's whole-forward limit)."""
    from tggcn_torch.models import cad120
    from tggcn_torch.models.registry import select_model

    model = select_model("2G-GCN", device=cuda, **dict(
        cad120.model_kwargs(dtype), hidden_size=24,
        **(cad120.SERVE_VARIANTS[variant] if variant else {})))
    params = model.init(torch.Generator().manual_seed(42))
    rng = np.random.default_rng(43)
    batch = cad120.make_request(rng, 3, 9, 1, 5)
    if variant:
        batch.update(cad120.make_distances(rng, 3, 9, 1, 5))
    bf16 = dtype == "bfloat16"
    before = _launch_counts(bf16)
    got, _ = model.apply(params, **batch)
    launched = [a - b for a, b in zip(_launch_counts(bf16), before)]
    assert launched == [1, 0, 0, 0, 0, 0, 0, int(variant == "dist")]
    want, _ = model.apply(params, use_kernels=False, **batch)
    assert _launch_counts(bf16) == [b + n for b, n in zip(before, launched)]
    for g, w_ in zip(got, want):
        if bf16:
            assert float((g - w_).abs().max()) <= 6e-4
        else:
            torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cad120_train_step_kernel_route(cuda, dtype):
    """One CAD-120 train step at hidden 24 on the kernel route (K1 and K2
    each launched once, no segment-scan kernel) against the plain route
    from the same weights: losses rtol 1e-5, leaves 1e-4 of their largest
    (bfloat16: 1e-2 and 3.9e-2); two kernel-route steps bitwise equal."""
    from tggcn_torch.models import cad120
    from tggcn_torch.train.loop import make_train_step, model_parameters, trainable_parameters

    model, criterion, feeder, data, targets = _cad120_setup(cuda, dtype)
    bf16 = dtype == "bfloat16"
    results = []
    for use_kernels in (True, False, True):
        trainable = {"model": model.init(torch.Generator().manual_seed(44))}
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=cad120.TRAIN["lr"])
        step = make_train_step(model, feeder, criterion, optimizer, use_kernels=use_kernels)
        before = _launch_counts(bf16)
        losses, _, _ = step(trainable, data, targets)
        launched = [a - b for a, b in zip(_launch_counts(bf16), before)]
        assert launched == ([1, 1] if use_kernels else [0, 0]) + [0] * 6
        results.append((losses, [p.grad for p in model_parameters(trainable["model"])]))
    (loss_k, grads_k), (loss_p, grads_p), (_, grads_again) = results
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-2 if bf16 else 1e-5, atol=0)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_p)
    for g_k, g_p in zip(grads_k, grads_p):
        limit = (3.9e-2 if bf16 else 1e-4) * max(float(g_p.abs().max()), floor)
        assert float((g_k - g_p).abs().max()) <= limit
    assert all(torch.equal(a, b) for a, b in zip(grads_k, grads_again))


def test_cad120_fused_steps_equal_eager_steps(cuda):
    """3 bfloat16 CAD-120 steps at hidden 24 captured once and replayed
    equal 3 eager kernel-route steps bit for bit (losses, every leaf,
    Adam's state); an eager step drawing its noise on the card makes no
    synchronizing call."""
    from tggcn_torch.train.loop import (gumbel_noise_stack, make_fused_train_steps,
                                        make_train_step)

    model, criterion, feeder, data, targets = _cad120_setup(cuda, "bfloat16")
    k = 3
    noise = gumbel_noise_stack(torch.Generator(device=cuda).manual_seed(45), k, 3, 9, 1, 5)
    eager = {"model": model.init(torch.Generator().manual_seed(46))}
    eager_opt = _adam(eager)
    step = make_train_step(model, feeder, criterion, eager_opt)
    want = torch.stack([step(eager, data, targets, noise={w: v[i] for w, v in noise.items()})[0]
                        for i in range(k)])
    fused_tree = {"model": model.init(torch.Generator().manual_seed(46))}
    fused_opt = _adam(fused_tree)
    fused = make_fused_train_steps(model, feeder, criterion, fused_opt)
    got, _ = fused(fused_tree, [x.expand(k, *x.shape) for x in data],
                   [y.expand(k, *y.shape) for y in targets], noise_stack=noise)
    assert torch.equal(got, want)
    leaves = lambda tree: [x for _, x in _flat_leaves(tree)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(fused_tree), leaves(eager)))
    for p, q in zip(fused_opt.param_groups[0]["params"], eager_opt.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fused_opt.state[p][key], eager_opt.state[q][key]), key
    gen = torch.Generator(device=cuda).manual_seed(47)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, _, _ = step(eager, data, targets, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(losses.isfinite().all())


GENERAL_CHANGES = {
    "relational_mp_sah": (dict(input_size=(2124, 2048), num_classes=(10, 12), gcn_node=19,
                               message_humans_to_human=False, message_type="v1",
                               message_granularity="v2", message_aggregation="mp",
                               attention_style="v1", object_segment_update_strategy="sah"),
                          1, 5, False),
    "specific_v1_features": (dict(input_size=(2168, 2048), num_classes=(14, None), gcn_node=30,
                                  message_granularity="v2", attention_style="v1",
                                  add_time_position=True, add_segment_length=True,
                                  cat_level_states=True), 2, 9, False),
    "no_segment_messages_bn_train": (dict(message_segment=False), 2, 4, True),
}


@pytest.mark.parametrize("name", list(GENERAL_CHANGES))
def test_general_variants_kernel_route(cuda, name):
    """A request of each configuration of chip_smoke.py's
    forward_general_variants at hidden 24 ('st' decisions taken): exactly
    K1 launches, once; against the plain route at rtol 1e-5, atol 1e-5."""
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model

    change, nh, no, bn_train = GENERAL_CHANGES[name]
    model = select_model("2G-GCN", device=cuda, **dict(
        stage1.MODEL_KWARGS, hidden_size=24, discrete_optimization_strategy="st", **change))
    params = model.init(torch.Generator().manual_seed(48))
    rng = np.random.default_rng(49)
    mask = np.ones((2, no), np.float32)
    mask[-1, no // 2:] = 0.0
    batch = dict(x_human=rng.standard_normal((2, 8, nh, model.config.input_size[0]),
                                             dtype=np.float32),
                 x_objects=rng.standard_normal((2, 8, no, 2048), dtype=np.float32),
                 objects_mask=mask, steps_per_example=np.array([8.0, 5.0], np.float32))
    before = _launch_counts(False)
    with torch.no_grad():
        got, _ = model.apply(params, train=bn_train, **batch)
        launched = [a - b for a, b in zip(_launch_counts(False), before)]
        want, _ = model.apply(params, train=bn_train, use_kernels=False, **batch)
    assert launched == [1] + [0] * 7
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [6, 100])
def test_kernels_at_unaligned_widths(cuda, h, dtype):
    """K1-K5 at a width their 16-byte copies do not take (6 in both dtypes,
    100 in bfloat16; 100 is float32's own): the wrappers run the kernel at
    the next width it takes (ops/widths.py), one launch a call as at an
    aligned width, against the plain version at the true width, at this
    file's limits (float32: 1e-5 absolute forward, 1e-5 of each output's
    largest backward; bfloat16: one ulp of each output's largest forward,
    1e-2 of it backward)."""
    from tggcn_torch.profile_gru import gru_bwd_inputs, gru_inputs
    from tggcn_torch.profile_scan import bwd_inputs, mode_inputs, scan_inputs

    io = getattr(torch, dtype)
    fwd_check = _within_one_ulp if io == BF16 else (
        lambda g, w, what: torch.testing.assert_close(g, w, rtol=0, atol=ATOL, msg=what))
    bwd_check = ((lambda g, w, what: _close_share(g, w, what, 1e-2)) if io == BF16
                 else _close_rel)

    def launched(wrapper, fn):
        key = "launches_bf16" if io == BF16 else "launches"
        before = getattr(wrapper, key)
        out = fn()
        assert getattr(wrapper, key) == before + 1, wrapper.__name__
        return out

    gen = torch.Generator(device=cuda).manual_seed(h)
    gru = tuple(x.to(io) for x in gru_inputs(cuda, gen, 9, 4, 20, h))
    got = launched(gru_sequence, lambda: gru_sequence(*gru, 2, keep=True))
    for name, g, w in zip(("h", "gates"), got, gru_sequence_plain(*gru, 2, keep=True)):
        fwd_check(g, w, f"K1 {name}")
    fwd_check(launched(gru_sequence, lambda: gru_sequence(*gru, 2)),
              gru_sequence_plain(*gru, 2), "K1 serving")
    args = gru_bwd_inputs(*gru, 2, gen)
    got = launched(gru_sequence_bwd, lambda: gru_sequence_bwd(*args, 2))
    for name, g, w in zip(("dgi", "dgh", "dh0"), got, gru_sequence_bwd_plain(*args, 2)):
        bwd_check(g, w, f"K2 {name}")

    scan = {k: v.to(io) for k, v in scan_inputs(cuda, gen, 9, 3, 2, 3, h).items()}
    scale = h ** -0.5
    got = launched(segment_scan_dot, lambda: segment_scan_dot(**scan, scale=scale))
    for name, g, w in zip(("h_h", "h_o", "att_oh") + KEPT, got,
                          segment_scan_dot_plain(**scan, scale=scale)):
        fwd_check(g, w, f"K3 {name}")
    bwd = bwd_inputs(scan, gen, scale)
    got = launched(segment_scan_dot_bwd, lambda: segment_scan_dot_bwd(**bwd, scale=scale))
    want = segment_scan_dot_bwd_plain(**bwd, scale=scale)
    for name in BWD_OUTPUTS:
        bwd_check(got[name], want[name], f"K4 {name}")
    for mode, wrapper in MODE_WRAPPERS.items():
        extra = {k: v.to(io) for k, v in
                 mode_inputs(mode, {k: v.float() for k, v in scan.items()}, gen).items()}
        got = launched(wrapper, lambda: wrapper(**scan, **extra))
        for name, g, w in zip(("h_h", "h_o", "att_oh"), got,
                              segment_scan_att_plain(mode, **scan, **extra)):
            fwd_check(g, w, f"K5 {mode} {name}")
