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


def _segment_args(cuda, nh, no, h):
    rng = np.random.default_rng(nh * 100 + h)
    t, b = 7, 5
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
