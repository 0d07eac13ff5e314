"""K1-K5 at hidden widths their kernels do not take (``ops/widths.py``): the
wrappers widen every operand to h' = ``aligned(h)`` (a multiple of 4 in
float32, of 8 in bfloat16), with zero units, run the kernel there and
narrow the outputs back. Here, on the CPU, the same padding runs around the
plain versions: ``pad -> plain -> slice``.

* For each of K1-K5, forward and backward (K5 has none, as JAX's), in
  float32 and bfloat16, at h in {6, 10, 20}, padded by at least one unit:
  the padded route against the plain version at the true width, every
  output and kept tensor within 4 float32 ulps of its largest value (the
  CPU's float32 products sum in blocks of the depth, which the padding
  changes; the readings were at most one ulp). The padded units of every
  output are what the proof in ``ops/widths.py`` says, exactly: states,
  messages and gradients 0, the kept gates r = z = 1/2, n = hn = 0.
* At an aligned width the padding copies nothing: the caller's tensors
  reach the kernel's function themselves.
* JAX's oracles at hidden 6, the width of JAX's own GRU kernel test
  (``tests/test_gru_pallas.py``): JAX's ``gru_sequence`` in interpret
  mode, forward and ``jax.vjp``, against the padded plain route (rtol
  1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-5, as
  ``tests/test_torch_gru.py``); JAX's 2G-GCN stage-1 model with its Pallas
  kernels in interpret mode (``use_pallas_gru``,
  ``use_pallas_segment_scan``, as ``tests/test_torch_bf16.py`` runs them)
  against the port's with every K1-K4 call on the padded plain route: the
  forward (the hard decisions equal, the heads rtol 1e-5, atol 1e-6), the
  loss of a train step's loss bundle (rtol 1e-5) and every gradient (rtol
  1e-3, atol 1e-5, as ``tests/test_torch_train.py``), one jax.value_and_grad
  (about a minute on the CPU, most of it the compile).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
import tggcn_torch.ops.gru_sequence as gru_ops
import tggcn_torch.ops.segment_scan as scan_ops
from test_torch_train import MISC, STAGE1, _batch, _flat, _flat_tensors
from tggcn.config import Config
from tggcn.data.loading import select_model_data_feeder as jax_feeder
from tggcn.models import select_model as jax_select_model
from tggcn.ops.gru_pallas import gru_sequence as jax_gru_sequence
from tggcn.train.losses import select_loss as jax_select_loss
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.data.feeders import select_model_data_feeder
from tggcn_torch.models.registry import select_model
from tggcn_torch.ops.widths import aligned, narrow, widen
from tggcn_torch.profile_scan import bwd_inputs, mode_inputs, scan_inputs
from tggcn_torch.train.loop import model_parameters
from tggcn_torch.train.losses import select_loss

WIDTHS = (6, 10, 20)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ULPS = 4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _close(got, want, what):
    got = list(got.values()) if isinstance(got, dict) else list(got)
    want = list(want.values()) if isinstance(want, dict) else list(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i, g.shape, w.shape)
        err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
        top = float(w.double().abs().max()) if w.numel() else 0.0
        assert err <= ULPS * 2.0 ** -23 * top, f"{what}, output {i}: {err:.3e} of {top:.3e}"


class Capture:
    """A run that records the padded outputs it returns."""

    def __init__(self, run):
        self.run, self.out = run, None

    def __call__(self, *args, **kwargs):
        self.out = self.run(*args, **kwargs)
        return self.out


def _pad_units(x, h, hp, blocks=1):
    """The padded units of each hp-wide block of x's last axis, (..., blocks, hp - h)."""
    return x.reshape(*x.shape[:-1], blocks, hp)[..., h:]


def _gru_inputs(h, dtype, seed, t=5, s=4, r=3):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    arrays = (rng.normal(size=(t, s, r, 3 * h)), rng.uniform(-bound, bound, size=(s, h, 3 * h)),
              rng.uniform(-bound, bound, size=(s, 3 * h)), rng.normal(size=(s, r, h)),
              rng.normal(size=(t, s, r, h)))
    return [torch.tensor(a, dtype=torch.float32).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", WIDTHS)
def test_gru_padded_route_equals_the_plain_version(h, dtype):
    dtype = DTYPES[dtype]
    hp = aligned(h + 1, dtype)
    gi, w_hh, b_hh, h0, g = _gru_inputs(h, dtype, seed=h)
    want, want_gates = gru_ops.gru_sequence_plain(gi, w_hh, b_hh, h0, 2, keep=True)
    run = Capture(gru_ops.gru_sequence_plain)
    got = gru_ops.gru_sequence_padded(run, gi, w_hh, b_hh, h0, 2, keep=True, width=hp)
    _close(got, (want, want_gates), "K1")
    _close([gru_ops.gru_sequence_padded(gru_ops.gru_sequence_plain, gi, w_hh, b_hh, h0, 2,
                                        width=hp)], [want], "K1 serving")
    wide, gates = run.out
    assert not _pad_units(wide, h, hp).any()
    r, z, hn = _pad_units(gates, h, hp, 3).unbind(-2)
    assert bool((r == 0.5).all() and (z == 0.5).all()) and not hn.any()

    hprev = gru_ops.previous_states(want, h0, 2)
    want = gru_ops.gru_sequence_bwd_plain(gi, hprev, g, want_gates, w_hh, 2)
    run = Capture(gru_ops.gru_sequence_bwd_plain)
    got = gru_ops.gru_sequence_bwd_padded(run, gi, hprev, g, want_gates, w_hh, 2, width=hp)
    _close(got, want, "K2")
    dgi, dgh, dh0 = run.out
    assert not (_pad_units(dgi, h, hp, 3).any() or _pad_units(dgh, h, hp, 3).any()
                or _pad_units(dh0, h, hp).any())


def _scan_inputs(h, dtype, seed, t=5, b=3, nh=2, no=3):
    gen = torch.Generator().manual_seed(seed)
    fwd = {k: v.to(dtype) for k, v in scan_inputs(torch.device("cpu"), gen, t, b, nh, no,
                                                   h).items()}
    return fwd, gen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", WIDTHS)
def test_scan_padded_route_equals_the_plain_version(h, dtype):
    """K3 with what it keeps, K4 on that, K5 in each mode."""
    dtype = DTYPES[dtype]
    hp = aligned(h + 1, dtype)
    fwd, gen = _scan_inputs(h, dtype, seed=h)
    scale = h ** -0.5
    want = scan_ops.segment_scan_dot_plain(**fwd, scale=scale)
    run = Capture(scan_ops.segment_scan_dot_plain)
    _close(scan_ops.segment_scan_dot_padded(run, *fwd.values(), scale=scale, width=hp), want,
           "K3")
    wide = dict(zip(scan_ops.SCAN_OUTPUTS + scan_ops.KEPT, run.out))
    for k, blocks in (("h_h", 1), ("h_o", 1), ("m_h", 2), ("m_o", 2), ("mix_h", 2),
                      ("mix_o", 2)):
        assert not _pad_units(wide[k], h, hp, blocks).any(), k
    for k in ("gates_h", "gates_o"):
        r, z, n, hn = _pad_units(wide[k], h, hp, 4).unbind(-2)
        assert bool((r == 0.5).all() and (z == 0.5).all()) and not (n.any() or hn.any()), k
    _close(scan_ops.segment_scan_dot_padded(scan_ops.segment_scan_dot_plain, *fwd.values(),
                                            scale=scale, keep=False, width=hp), want[:3],
           "K3 serving")

    bwd = bwd_inputs(fwd, gen, scale)
    want = scan_ops.segment_scan_dot_bwd_plain(**bwd, scale=scale)
    run = Capture(scan_ops.segment_scan_dot_bwd_plain)
    _close(scan_ops.segment_scan_dot_bwd_padded(run, *bwd.values(), scale=scale, width=hp),
           want, "K4")
    for k, blocks in (("dgi_h", 3), ("dgi_o", 3), ("dgh_h", 3), ("dgh_o", 3), ("dpre_h", 2),
                      ("dpre_o", 2), ("dh0_h", 1), ("dh0_o", 1)):
        assert not _pad_units(run.out[k], h, hp, blocks).any(), k

    for mode in scan_ops.MODES:
        extra = {k: v.to(dtype) for k, v in
                 mode_inputs(mode, {k: v.float() for k, v in fwd.items()}, gen).items()}
        want = scan_ops.segment_scan_att_plain(mode, *fwd.values(), **extra)
        run = Capture(scan_ops.segment_scan_att_plain)
        _close(scan_ops.segment_scan_att_padded(run, mode, *fwd.values(), width=hp, **extra),
               want, f"K5 {mode}")
        assert not (_pad_units(run.out[0], h, hp).any() or _pad_units(run.out[1], h, hp).any())


def test_aligned_width_copies_nothing():
    seen = []
    keep = lambda *args, **kwargs: seen.append(args) or "ran"
    gi, w_hh, b_hh, h0, g = _gru_inputs(8, torch.float32, seed=0)
    assert gru_ops.gru_sequence_padded(keep, gi, w_hh, b_hh, h0) == "ran"
    assert all(a is b for a, b in zip(seen[0], (gi, w_hh, b_hh, h0)))
    fwd, _ = _scan_inputs(8, torch.bfloat16, seed=0)
    assert scan_ops.segment_scan_dot_padded(keep, *fwd.values(), scale=1.0) == "ran"
    assert all(a is b for a, b in zip(seen[1], fwd.values()))
    assert aligned(6, torch.float32) == aligned(6, torch.bfloat16) == 8
    assert (aligned(100, torch.float32), aligned(100, torch.bfloat16)) == (100, 104)
    x = torch.arange(12.0).reshape(2, 6)
    halves = ((-1, 2),)
    assert torch.equal(narrow(widen(x, 3, 5, halves), 3, 5, halves), x)
    assert widen(x, 3, 5, halves)[0].tolist() == [0, 1, 2, 0, 0, 3, 4, 5, 0, 0]
    w = torch.arange(1.0, 13.0).reshape(2, 6)                     # (h, 3h), h = 2
    both = ((-2, 1), (-1, 3))
    wide = widen(w, 2, 3, both)
    assert wide.shape == (3, 9) and not wide[2].any() and not wide[:, 2::3].any()
    assert torch.equal(wide[:2].reshape(2, 3, 3)[..., :2].reshape(2, 6), w)
    assert torch.equal(narrow(wide, 2, 3, both), w)


def _padded(orig, padded, inputs):
    """orig (a plain version) as the padded route: its tensors of `inputs`
    widened to aligned(h), the rest of its arguments passed on."""
    signature = inspect.signature(orig)

    def run(*args, **kwargs):
        bound = signature.bind(*args, **kwargs).arguments
        return padded(orig, *(bound.pop(k) for k in inputs), **bound)
    return run


@pytest.fixture
def padded_route(monkeypatch):
    """Every K1-K4 call of the port on the CPU through the padded plain route."""
    for owner, name, padded, inputs in (
            (gru_ops, "gru_sequence_plain", gru_ops.gru_sequence_padded,
             ("gi", "w_hh", "b_hh", "h0")),
            (gru_ops, "gru_sequence_bwd_plain", gru_ops.gru_sequence_bwd_padded,
             ("gi", "hprev", "g", "gates", "w_hh")),
            (scan_ops, "segment_scan_dot_plain", scan_ops.segment_scan_dot_padded,
             scan_ops.SCAN_INPUTS),
            (scan_ops, "segment_scan_dot_bwd_plain", scan_ops.segment_scan_dot_bwd_padded,
             scan_ops.BWD_INPUTS)):
        monkeypatch.setattr(owner, name, _padded(getattr(owner, name), padded, inputs))
    calls = []
    monkeypatch.setattr(scan_ops, "_resize", lambda *a, _r=scan_ops._resize, **k:
                        calls.append(a[1:3]) or _r(*a, **k))
    return calls


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_at_hidden_6_matches_jax(reverse, padded_route):
    gi, w_hh, b_hh, h0, g = (x.numpy() for x in _gru_inputs(6, torch.float32, seed=7))
    want, vjp = jax.vjp(lambda *a: jax_gru_sequence(*a, reverse, True), gi, w_hh, b_hh, h0)
    leaves = [torch.tensor(x, requires_grad=True) for x in (gi, w_hh, b_hh, h0)]
    got = gru_ops.gru_sequence_autograd(*leaves, num_reverse=gi.shape[1] if reverse else 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    got.backward(torch.tensor(g))
    for name, leaf, w in zip(("dgi", "dW_hh", "db_hh", "dh0"), leaves, vjp(g)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_model_at_hidden_6_matches_jax(monkeypatch, padded_route):
    """JAX's stage-1 model on its Pallas kernels (interpret mode) and the
    port's on the padded plain route: forward, loss and every gradient."""
    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    monkeypatch.setattr(gru_pallas, "run_multi_bigru_pallas",
                        lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(scan_pallas, "run_segment_scan_pallas",
                        lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    kwargs = dict(STAGE1, hidden_size=6, discrete_optimization_strategy="st")
    jax_model = jax_select_model("2G-GCN", use_pallas_gru=True, use_pallas_segment_scan=True,
                                 **kwargs)
    jax_params = jax_model.init(jax.random.PRNGKey(1))
    batch = _batch(seed=2)
    data, targets = batch[:8], batch[8:]
    jax_criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": MISC}))
    jax_kwargs = jax_feeder("2G-GCN", "multiple", dataset_name="mphoi")(data)

    def jax_loss(p):
        out, _ = jax_model.apply(p, train=True, rng=jax.random.PRNGKey(3), **jax_kwargs)
        return sum(jax_criterion(out, targets)), out

    (want_total, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_params)

    model = select_model("2G-GCN", device="cpu", **kwargs)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    for p in model_parameters(params):
        p.requires_grad_(True)
    out, _ = model.apply(params, train=True,
                         **select_model_data_feeder("2G-GCN", "multiple",
                                                    dataset_name="mphoi")(data))
    assert padded_route and all(hp == 8 for h, hp in padded_route)   # the scan ran at h' = 8
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(want_out[0]))
    for i in (2, 3, 4, 5):
        np.testing.assert_allclose(out[i].detach().numpy(), np.asarray(want_out[i]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=f"output {i}")
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    total = sum(criterion(out, [torch.tensor(y) for y in targets]))
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    total.backward()
    got = {k: leaf.grad for k, leaf in _flat_tensors(params).items() if leaf.grad is not None}
    want = {k: v for k, v in _flat(want_grads).items() if "/bn/state/" not in k}
    assert set(got) <= set(want)
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)
