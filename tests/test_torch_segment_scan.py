"""K3, K4 and K5 of the port: the plain versions of tggcn_torch's
segment_scan_dot and its backward against the JAX Pallas segment kernel
(mode 'dot') and its hand-written custom VJP (``_seg_dir``), and K5's plain
version against the same kernel in modes 'v1', 'v4' and 'ext' (distance and
mean-pooling weights), run in interpret mode, one direction at a time; the
port's whole fast-path scan against JAX's ``_segment_scan_fast`` in every
mode.

Random commit decisions (so the (1 - u) h_prev branch runs), a partly
masked object row and a row with every object masked; with one human the
h2h attention row is fully masked too. Tolerance rtol 1e-5, atol 1e-6 for
the forward; rtol 1e-4, atol 1e-5 for the gradients, whose carry sums over
the sequence (tests/test_segment_scan_pallas.py holds the Pallas backward
to rtol 2e-4). The float64 gradcheck uses torch's default tolerances.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import _segment_scan_fast as jax_segment_scan_fast
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn.ops.segment_scan_pallas import _external_att_weights, _seg_dir, _seg_dir_pallas
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.models.tggcn import (TGGCNConfig, _segment_scan_fast, external_att_weights,
                                      segment_mode)
from tggcn_torch.ops.segment_scan import (segment_scan_att_plain, segment_scan_dot,
                                          segment_scan_dot_autograd)

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# The differentiable inputs, in segment_scan_dot's order (obj_mask is not one).
DIFFERENTIABLE = ("gi_h", "gi_o", "u_h", "u_o", "w_from", "b_from", "w_msg_h", "w_msg_o",
                  "w_hh_h", "w_hh_o", "b_hh_h", "b_hh_o", "h0_h", "h0_o")


def _inputs(t, b, nh, no, h, seed):
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(h)
    w = lambda *shape: rng.uniform(-bound, bound, size=shape).astype(np.float32)
    mask = np.ones((b, no), np.float32)
    mask[0, -1] = 0.0
    mask[-1] = 0.0
    return dict(
        gi_h=rng.normal(size=(2, t, b, nh, 3 * h)).astype(np.float32),
        gi_o=rng.normal(size=(2, t, b, no, 3 * h)).astype(np.float32),
        u_h=(rng.uniform(size=(t, b, nh)) > 0.5).astype(np.float32),
        u_o=(rng.uniform(size=(t, b, no)) > 0.5).astype(np.float32),
        w_from=w(4, h, h), b_from=w(4, h),
        w_msg_h=w(2, 2 * h, 3 * h), w_msg_o=w(2, 2 * h, 3 * h),
        w_hh_h=w(2, h, 3 * h), w_hh_o=w(2, h, 3 * h),
        b_hh_h=w(2, 3 * h), b_hh_o=w(2, 3 * h), obj_mask=mask,
        h0_h=rng.normal(size=(2, b, nh, h)).astype(np.float32) * 0.5,
        h0_o=rng.normal(size=(2, b, no, h)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("nh,style", [(2, "v3"), (1, "v2")])
def test_segment_scan_matches_pallas(nh, style):
    t, b, no, h = 6, 3, 3, 8
    a = _inputs(t, b, nh, no, h, seed=nh)
    scale = 1.0 / math.sqrt(h) if style == "v3" else 1.0
    got_h, got_o, got_att, _, _ = segment_scan_dot(**{k: torch.tensor(v) for k, v in a.items()},
                                             scale=scale)
    for d, reverse in ((0, False), (1, True)):
        want_h, want_o, want_att = _seg_dir_pallas(
            a["gi_h"][d], a["gi_o"][d], a["u_h"], a["u_o"], a["w_from"], a["b_from"],
            a["w_msg_h"][d], a["w_msg_o"][d], a["w_hh_h"][d], a["w_hh_o"][d],
            a["b_hh_h"][d], a["b_hh_o"][d], 1.0 - np.eye(nh, dtype=np.float32),
            a["obj_mask"], 1.0 - np.eye(no, dtype=np.float32), a["h0_h"][d], a["h0_o"][d],
            scale=scale, reverse=reverse, interpret=True, mode="dot")
        for name, g, w in (("h_h", got_h[d], want_h), ("h_o", got_o[d], want_o),
                           ("att_oh", got_att[d], want_att)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}, direction {d}")
    # The batch row with every object masked attends to no object.
    assert not got_att[:, :, -1].any()
    assert torch.isfinite(got_h).all() and torch.isfinite(got_o).all()


def _jax_vjp(a, nh, no, scale, g_h, g_o, g_att):
    """Gradients of both directions through _seg_dir's Pallas VJP, summed
    into the port's layout (direction-stacked leaves, shared u and w_from)."""
    want = {k: np.zeros_like(a[k]) for k in DIFFERENTIABLE}
    for d, reverse in ((0, False), (1, True)):
        args = [a["gi_h"][d], a["gi_o"][d], a["u_h"], a["u_o"], a["w_from"], a["b_from"],
                a["w_msg_h"][d], a["w_msg_o"][d], a["w_hh_h"][d], a["w_hh_o"][d],
                a["b_hh_h"][d], a["b_hh_o"][d], 1.0 - np.eye(nh, dtype=np.float32),
                a["obj_mask"], 1.0 - np.eye(no, dtype=np.float32), a["h0_h"][d], a["h0_o"][d]]
        _, vjp = jax.vjp(lambda *x: _seg_dir(scale, reverse, True, False, *x), *args)
        grads = [np.asarray(x) for x in vjp((g_h[d], g_o[d], g_att[d]))]
        for k, i in (("gi_h", 0), ("gi_o", 1), ("w_msg_h", 6), ("w_msg_o", 7), ("w_hh_h", 8),
                     ("w_hh_o", 9), ("b_hh_h", 10), ("b_hh_o", 11), ("h0_h", 15),
                     ("h0_o", 16)):
            want[k][d] = grads[i]
        for k, i in (("u_h", 2), ("u_o", 3), ("w_from", 4), ("b_from", 5)):
            want[k] += grads[i]
    return want


@pytest.mark.parametrize("nh,g_att_zero", [(2, False), (1, False), (2, True)],
                         ids=["two_humans", "one_human", "no_attention_gradient"])
def test_segment_scan_backward_matches_pallas(nh, g_att_zero):
    """Every gradient of the scan through the autograd Function (K4's plain
    version) against jax.vjp of the Pallas custom VJP, with soft commit
    decisions u in (0, 1), a nonzero gradient on the attention output (or
    none at all), a partly and a fully masked object row, and one human."""
    t, b, no, h = 5, 3, 3, 8
    a = _inputs(t, b, nh, no, h, seed=10 + nh)
    rng = np.random.default_rng(20 + nh)
    a["u_h"] = rng.uniform(size=a["u_h"].shape).astype(np.float32)
    a["u_o"] = rng.uniform(size=a["u_o"].shape).astype(np.float32)
    scale = 1.0 / math.sqrt(h)
    g_h = rng.normal(size=(2, t, b, nh, h)).astype(np.float32)
    g_o = rng.normal(size=(2, t, b, no, h)).astype(np.float32)
    g_att = rng.normal(size=(2, t, b, nh, no)).astype(np.float32) * (0.0 if g_att_zero else 1.0)
    want = _jax_vjp(a, nh, no, scale, g_h, g_o, g_att)
    leaves = {k: torch.tensor(v, requires_grad=k in DIFFERENTIABLE) for k, v in a.items()}
    out_h, out_o, att = segment_scan_dot_autograd(**leaves, scale=scale)
    if g_att_zero:
        torch.autograd.backward([out_h, out_o], [torch.tensor(g_h), torch.tensor(g_o)])
    else:
        torch.autograd.backward([out_h, out_o, att],
                                [torch.tensor(g_h), torch.tensor(g_o), torch.tensor(g_att)])
    for k in DIFFERENTIABLE:
        got = leaves[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_segment_scan_backward_gradcheck():
    """The plain backward against finite differences of the plain forward in
    float64, with a fully masked object row and soft commit decisions."""
    t, b, nh, no, h = 3, 2, 2, 2, 4
    a = _inputs(t, b, nh, no, h, seed=30)
    rng = np.random.default_rng(31)
    a["u_h"] = rng.uniform(size=a["u_h"].shape)
    a["u_o"] = rng.uniform(size=a["u_o"].shape)
    leaves = {k: torch.tensor(v, dtype=torch.float64, requires_grad=k in DIFFERENTIABLE)
              for k, v in a.items()}
    names = list(leaves)

    def run(*xs):
        return segment_scan_dot_autograd(**dict(zip(names, xs)), scale=0.5)

    assert torch.autograd.gradcheck(run, [leaves[k] for k in names])


def _distances(rng, b, t, nh, no):
    """Positive distances (B, T, R, S) with about a fifth exact zeros, which
    distance-based attention masks."""
    def d(r, s):
        return np.where(rng.uniform(size=(b, t, r, s)) < 0.2, 0.0,
                        rng.uniform(0.1, 3.0, size=(b, t, r, s))).astype(np.float32)
    return d(nh, nh), d(nh, no), d(no, no)


def _pack(parts, nh):
    """Four (T, B, R, S) weights (hh, oh, ho, oo) as the port's (T, B, E, E)."""
    a_hh, a_oh, a_ho, a_oo = (np.asarray(p) for p in parts)
    return np.concatenate([np.concatenate([a_hh, a_oh], -1),
                           np.concatenate([a_ho, a_oo], -1)], -2)


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
@pytest.mark.parametrize("mode", ["v1", "v4", "ext_dist", "ext_mp"])
def test_segment_scan_modes_match_pallas(mode, nh):
    """K5's plain version in each mode against the Pallas kernel, with a
    partly and a fully masked object row (and, with one human, an empty h2h
    row); the 'ext' weights from the port's external_att_weights against
    JAX's _external_att_weights."""
    t, b, no, h = 6, 3, 3, 8
    a = _inputs(t, b, nh, no, h, seed=40 + nh)
    rng = np.random.default_rng(50 + nh)
    jax_extra, port_extra = {}, {}
    if mode in ("v1", "v4"):
        shape = (4, 2 * h, 1) if mode == "v1" else (4, h, h)
        w_att = rng.uniform(-1, 1, size=shape).astype(np.float32) / math.sqrt(h)
        b_att = rng.uniform(-0.5, 0.5, size=(4, 1)).astype(np.float32)
        jax_extra = dict(w_att=w_att, b_att=b_att)
        port_extra = dict(w_att=torch.tensor(w_att.reshape(4, -1) if mode == "v1" else w_att),
                          b_att=torch.tensor(b_att[:, 0]))
    else:
        cfg = SimpleNamespace(message_aggregation="mp" if mode == "ext_mp" else "att")
        dists3 = _distances(rng, b, t, nh, no)
        want = _external_att_weights(cfg, dists3, a["obj_mask"], b, t, nh, no, jnp.float32)
        got = external_att_weights(mode == "ext_mp", [torch.tensor(d) for d in dists3],
                                   torch.tensor(a["obj_mask"]), t, nh)
        np.testing.assert_allclose(got.numpy(), _pack(want, nh), rtol=RTOL, atol=ATOL)
        jax_extra = dict(att_ws=tuple(np.asarray(w) for w in want))
        port_extra = dict(att_ext=got)
    kernel_mode = mode[:3]
    got_h, got_o, got_att = segment_scan_att_plain(
        kernel_mode, **{k: torch.tensor(v) for k, v in a.items()}, **port_extra)
    for d, reverse in ((0, False), (1, True)):
        want_h, want_o, want_att = _seg_dir_pallas(
            a["gi_h"][d], a["gi_o"][d], a["u_h"], a["u_o"], a["w_from"], a["b_from"],
            a["w_msg_h"][d], a["w_msg_o"][d], a["w_hh_h"][d], a["w_hh_o"][d],
            a["b_hh_h"][d], a["b_hh_o"][d], 1.0 - np.eye(nh, dtype=np.float32),
            a["obj_mask"], 1.0 - np.eye(no, dtype=np.float32), a["h0_h"][d], a["h0_o"][d],
            scale=1.0, reverse=reverse, interpret=True, mode=kernel_mode, **jax_extra)
        for name, g, w in (("h_h", got_h[d], want_h), ("h_o", got_o[d], want_o),
                           ("att_oh", got_att[d], want_att)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}, direction {d}")
    assert not got_att[:, :, -1].any()
    assert torch.isfinite(got_h).all() and torch.isfinite(got_o).all()


SCAN_CONFIG = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=8,
                   message_segment=True, message_type="v2", message_granularity="v1",
                   message_aggregation="att", attention_style="v3")


@pytest.mark.parametrize("variant", [
    {"attention_style": "v3"}, {"attention_style": "v2"}, {"attention_style": "v1"},
    {"attention_style": "v4"}, {"message_aggregation": "mp"}, {"distances": True}],
    ids=["v3", "v2", "v1", "v4", "mp", "dist"])
def test_fast_scan_matches_jax(variant):
    """The port's whole segment scan (K3 or K5 by mode, plain on the CPU)
    against JAX's _segment_scan_fast, from one init_tggcn parameter set,
    with soft commit decisions and a fully masked object row."""
    kwargs = dict(SCAN_CONFIG, **{k: v for k, v in variant.items() if k != "distances"})
    jax_cfg = JaxConfig.from_kwargs(**kwargs)
    jax_params = jax_init(jax.random.PRNGKey(1), jax_cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    b, t, nh, no, h = 2, 5, 2, 3, 8
    rng = np.random.default_rng(7)
    x_hs = rng.normal(size=(b, t, nh, 3 * h)).astype(np.float32)
    x_os = rng.normal(size=(b, t, no, 4 * h)).astype(np.float32)
    u_h = rng.uniform(size=(b, t, nh)).astype(np.float32)
    u_o = rng.uniform(size=(b, t, no)).astype(np.float32)
    mask = np.ones((b, no), np.float32)
    mask[0, 1] = 0.0
    mask[1] = 0.0
    dists3 = _distances(rng, b, t, nh, no) if variant.get("distances") else (None,) * 3
    want = jax_segment_scan_fast(jax_params, jax_cfg, x_hs, x_os, u_h, u_o, mask, *dists3)
    cfg = TGGCNConfig.from_kwargs(**kwargs)
    tensor = lambda x: None if x is None else torch.tensor(x)
    dists = [tensor(d) for d in dists3]
    with torch.no_grad():
        got = _segment_scan_fast(params, cfg, segment_mode(cfg, dists), tensor(x_hs),
                                 tensor(x_os), tensor(u_h), tensor(u_o), tensor(mask), dists)
    for name, g, w in zip(("hx_hs", "hx_os", "att_fwd", "att_bwd"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)
