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

In bfloat16, K3's and K4's plain versions against the Pallas kernel in
bfloat16 with both directions fused (``_seg_dir`` with fuse_dirs, as the
JAX package runs bfloat16) in interpret mode, forward and jax.vjp, with one
and two humans and the masked object rows: every output and gradient
within two bfloat16 ulps of its largest value (the TPU kernel's backward
recomputes the gates and attention from the bfloat16 states, the port's
reads what the forward kept from the float32 states).
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
import tggcn_torch.ops.segment_scan as scan_ops
from tggcn_torch.ops.segment_scan import (BWD_OUTPUTS, KEPT, _attention, _dot_scores,
                                          previous_states, scan_buffers,
                                          segment_scan_att_plain, segment_scan_dot,
                                          segment_scan_dot_autograd, segment_scan_dot_bwd_plain,
                                          segment_scan_dot_plain, segment_scan_dot_weight_grads)

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
    got_h, got_o, got_att, *_ = segment_scan_dot(**{k: torch.tensor(v) for k, v in a.items()},
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


def _bwd_recompute(gi_h, gi_o, u_h, u_o, hprev_h, hprev_o, m_h, m_o, g_h, g_o, g_att, w_from,
                   w_msg_h, w_msg_o, w_hh_h, w_hh_o, b_hh_h, b_hh_o, obj_mask, scale):
    """The backward route K4 took before K3 kept its gates, mixed messages
    and attention: every step recomputes the scores, the softmax, the mixing
    and the gate products from h_prev and the kept edge messages. Returns
    the same outputs as segment_scan_dot_bwd_plain, and the recomputed mixed
    messages as msgs_h, msgs_o."""
    h, t = w_hh_h.shape[1], gi_h.shape[1]
    out = dict(dgi_h=torch.empty_like(gi_h), dgi_o=torch.empty_like(gi_o),
               dgh_h=torch.empty_like(gi_h), dgh_o=torch.empty_like(gi_o),
               msgs_h=gi_h.new_empty(gi_h.shape[:-1] + (2 * h,)),
               msgs_o=gi_o.new_empty(gi_o.shape[:-1] + (2 * h,)),
               dpre_h=gi_h.new_empty(gi_h.shape[:-1] + (2 * h,)),
               dpre_o=gi_o.new_empty(gi_o.shape[:-1] + (2 * h,)),
               du_h=gi_h.new_empty(gi_h.shape[:-1]), du_o=gi_o.new_empty(gi_o.shape[:-1]))
    dh_h, dh_o = hprev_h.new_zeros(hprev_h[:, 0].shape), hprev_o.new_zeros(hprev_o[:, 0].shape)

    def cell_bwd(gib, msgs, hp, u, dH, w_msg, w_hh, b_hh):
        gi = gib + torch.einsum("dbnf,dfk->dbnk", msgs, w_msg)
        gh = torch.einsum("dbnh,dhk->dbnk", hp, w_hh) + b_hh[:, None, None]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * hp
        du = torch.sum(dH * (h_new - hp), dim=-1)
        dh_new = dH * u[..., None]
        dtanh = dh_new * (1.0 - z) * (1.0 - n * n)
        d_ir = dtanh * h_n * r * (1.0 - r)
        d_iz = dh_new * (hp - n) * z * (1.0 - z)
        dgi = torch.cat([d_ir, d_iz, dtanh], dim=-1)
        dgh = torch.cat([d_ir, d_iz, dtanh * r], dim=-1)
        dhp = (dH * (1.0 - u[..., None]) + dh_new * z
               + torch.einsum("dbnk,dhk->dbnh", dgh, w_hh))
        return dgi, dgh, du, dhp, torch.einsum("dbnk,dfk->dbnf", dgi, w_msg)

    def att_bwd(a, m, dmg, recv, send, e, extra=None):
        da = torch.einsum("dbrh,dbsh->dbrs", dmg, m)
        if extra is not None:
            da = da + extra
        dm = torch.einsum("dbrs,dbrh->dbsh", a, dmg)
        ds = a * (da - torch.sum(da * a, dim=-1, keepdim=True))
        dpre = dm * (m > 0).to(dm.dtype)
        dsend = scale * torch.einsum("dbrs,dbrh->dbsh", ds, recv)
        dsend = dsend + torch.matmul(dpre, w_from[e].transpose(0, 1))
        return scale * torch.einsum("dbrs,dbsh->dbrh", ds, send), dsend, dpre

    for i in range(t):
        ts = (t - 1 - i, i)

        def at(x):
            return torch.stack([x[d, ts[d]] for d in range(2)])

        hh, ho = at(hprev_h), at(hprev_o)
        (m_hh, m_ho), (m_oh, m_oo) = at(m_h).chunk(2, dim=-1), at(m_o).chunk(2, dim=-1)
        a_hh, a_oh, a_ho, a_oo = _attention(hh, ho, obj_mask, _dot_scores(scale))
        msgs_h = torch.cat([a_hh @ m_hh, a_oh @ m_oh], dim=-1)
        msgs_o = torch.cat([a_ho @ m_ho, a_oo @ m_oo], dim=-1)
        uh = torch.stack([u_h[ts[d]] for d in range(2)])
        uo = torch.stack([u_o[ts[d]] for d in range(2)])
        dgi_h, dgh_h, du_h, dhp_h, dmsgs_h = cell_bwd(
            at(gi_h), msgs_h, hh, uh, dh_h + at(g_h), w_msg_h, w_hh_h, b_hh_h)
        dgi_o, dgh_o, du_o, dhp_o, dmsgs_o = cell_bwd(
            at(gi_o), msgs_o, ho, uo, dh_o + at(g_o), w_msg_o, w_hh_o, b_hh_o)
        dr_hh, ds_hh, dp_hh = att_bwd(a_hh, m_hh, dmsgs_h[..., :h], hh, hh, 0)
        dr_oh, ds_oh, dp_oh = att_bwd(a_oh, m_oh, dmsgs_h[..., h:], hh, ho, 2, at(g_att))
        dr_ho, ds_ho, dp_ho = att_bwd(a_ho, m_ho, dmsgs_o[..., :h], ho, hh, 1)
        dr_oo, ds_oo, dp_oo = att_bwd(a_oo, m_oo, dmsgs_o[..., h:], ho, ho, 3)
        dh_h = dhp_h + dr_hh + ds_hh + dr_oh + ds_ho
        dh_o = dhp_o + ds_oh + dr_ho + dr_oo + ds_oo
        step = dict(dgi_h=dgi_h, dgi_o=dgi_o, dgh_h=dgh_h, dgh_o=dgh_o, msgs_h=msgs_h,
                    msgs_o=msgs_o, dpre_h=torch.cat([dp_hh, dp_ho], dim=-1),
                    dpre_o=torch.cat([dp_oh, dp_oo], dim=-1), du_h=du_h, du_o=du_o)
        for k, v in step.items():
            for d in range(2):
                out[k][d, ts[d]] = v[d]
    out.update(dh0_h=dh_h, dh0_o=dh_o)
    return out


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
def test_kept_backward_matches_recompute_route(nh):
    """K4's plain version, which reads the gates, mixed messages and
    attention K3 kept, against the route it replaces (recomputing them from
    h_prev each step) and, through the autograd Function, against jax.vjp of
    the Pallas custom VJP; soft commit decisions, a partly and a fully
    masked object row, and with one human an empty h2h row."""
    t, b, no, h = 5, 3, 3, 8
    a = _inputs(t, b, nh, no, h, seed=60 + nh)
    rng = np.random.default_rng(70 + nh)
    a["u_h"] = rng.uniform(size=a["u_h"].shape).astype(np.float32)
    a["u_o"] = rng.uniform(size=a["u_o"].shape).astype(np.float32)
    scale = 1.0 / math.sqrt(h)
    g = dict(g_h=rng.normal(size=(2, t, b, nh, h)).astype(np.float32),
             g_o=rng.normal(size=(2, t, b, no, h)).astype(np.float32),
             g_att=rng.normal(size=(2, t, b, nh, no)).astype(np.float32))
    x = {k: torch.tensor(v) for k, v in {**a, **g}.items()}
    out_h, out_o, _, *kept = segment_scan_dot_plain(
        **{k: x[k] for k in a}, scale=scale)
    kept = dict(zip(KEPT, kept))
    hprev = dict(hprev_h=previous_states(out_h, x["h0_h"]),
                 hprev_o=previous_states(out_o, x["h0_o"]))
    weights = ("w_from", "w_msg_h", "w_msg_o", "w_hh_h", "w_hh_o")
    got = segment_scan_dot_bwd_plain(
        x["u_h"], x["u_o"], **hprev, **{k: kept[k] for k in ("m_h", "m_o", "gates_h",
                                                                 "gates_o", "atts")},
        g_h=x["g_h"], g_o=x["g_o"], g_att=x["g_att"], **{k: x[k] for k in weights},
        scale=scale)
    want = _bwd_recompute(
        x["gi_h"], x["gi_o"], x["u_h"], x["u_o"], **hprev, m_h=kept["m_h"], m_o=kept["m_o"],
        g_h=x["g_h"], g_o=x["g_o"], g_att=x["g_att"], **{k: x[k] for k in weights},
        b_hh_h=x["b_hh_h"], b_hh_o=x["b_hh_o"], obj_mask=x["obj_mask"], scale=scale)
    for k in BWD_OUTPUTS:
        assert torch.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    for k in ("mix_h", "mix_o"):
        np.testing.assert_allclose(kept[k].numpy(), want["msgs" + k[3:]].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(
        torch.cat([t_.flatten() for t_ in segment_scan_dot_weight_grads(
            *hprev.values(), kept["mix_h"], kept["mix_o"], got)]).numpy(),
        torch.cat([t_.flatten() for t_ in _weight_grads_recompute(hprev, want)]).numpy(),
        rtol=GRAD_RTOL, atol=GRAD_ATOL)
    jax_want = _jax_vjp(a, nh, no, scale, g["g_h"], g["g_o"], g["g_att"])
    leaves = {k: torch.tensor(v, requires_grad=k in DIFFERENTIABLE) for k, v in a.items()}
    outs = segment_scan_dot_autograd(**leaves, scale=scale)
    torch.autograd.backward(list(outs), [x["g_h"], x["g_o"], x["g_att"]])
    for k in DIFFERENTIABLE:
        np.testing.assert_allclose(leaves[k].grad.numpy(), jax_want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _weight_grads_recompute(hprev, grads):
    """The weight gradients as the recompute route reduced them, from its
    own recomputed mixed messages."""
    return segment_scan_dot_weight_grads(hprev["hprev_h"], hprev["hprev_o"], grads["msgs_h"],
                                         grads["msgs_o"], grads)


def _small_leaves(requires_grad):
    a = _inputs(3, 2, 2, 2, 4, seed=80)
    return {k: torch.tensor(v, requires_grad=requires_grad and k in DIFFERENTIABLE)
            for k, v in a.items()}


def test_scan_keeps_tensors_only_for_a_backward(monkeypatch):
    """SegmentScanDot saves K3's kept tensors (messages, gates, mixed
    messages, attention) when a gradient will be taken; under no_grad, or
    when no input requires a gradient, the forward runs with keep=False and
    returns no autograd history."""
    import tggcn_torch.ops.segment_scan as scan_ops

    calls = []
    plain = scan_ops.segment_scan_dot_plain

    def spy(*args, keep=True, **kwargs):
        calls.append(keep)
        return plain(*args, keep=keep, **kwargs)

    monkeypatch.setattr(scan_ops, "segment_scan_dot_plain", spy)
    leaves = _small_leaves(requires_grad=True)
    out_h, _, _ = scan_ops.segment_scan_dot_autograd(**leaves, scale=0.5, use_kernels=False)
    saved = out_h.grad_fn.saved_tensors
    h = leaves["w_hh_h"].shape[1]
    assert calls == [True]
    assert len(saved) == len(DIFFERENTIABLE) + 1 + 2 + len(KEPT)
    assert [tuple(x.shape[-1:]) for x in saved[-len(KEPT):]] == [
        (2 * h,), (2 * h,), (4 * h,), (4 * h,), (2 * h,), (2 * h,), (4,)]
    with torch.no_grad():
        served = scan_ops.segment_scan_dot_autograd(**leaves, scale=0.5, use_kernels=False)
    fixed = scan_ops.segment_scan_dot_autograd(**_small_leaves(requires_grad=False), scale=0.5,
                                               use_kernels=False)
    assert calls == [True, False, False]
    for outs in (served, fixed):
        assert len(outs) == 3 and all(x.grad_fn is None for x in outs)
        torch.testing.assert_close(outs[0], out_h.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("keep", [False, True], ids=["serving", "training"])
def test_scan_buffers_hold_steps_only_when_kept(keep):
    """What the K3 wrapper allocates: serving (keep=False) allocates no
    per-step messages, gates or attention, only one step's edge and mixed
    messages per direction, whatever the length; training keeps every
    step's."""
    t, b, nh, no, h = 7, 2, 2, 3, 8
    (out, kept), (out_long, kept_long) = (scan_buffers(n, b, nh, no, h, keep, "cpu")
                                          for n in (t, 10 * t))
    assert [tuple(x.shape) for x in out] == [(2, t, b, nh, h), (2, t, b, no, h),
                                             (2, t, b, nh, no)]
    if keep:
        assert sorted(kept) == sorted(KEPT)
        assert tuple(kept["gates_o"].shape) == (2, t, b, no, 4 * h)
        assert tuple(kept["atts"].shape) == (2, t, b, nh + no, nh + no)
    else:
        assert sorted(kept) == ["m_h", "m_o", "mix_h", "mix_o"]
        assert {k: tuple(v.shape) for k, v in kept.items()} == {
            k: tuple(v.shape) for k, v in kept_long.items()}
        assert tuple(kept["m_o"].shape) == (2, b, no, 2 * h)


def test_profile_inputs_drive_the_scan_and_its_backward():
    """tggcn_torch.profile_scan's seeded inputs, which the card's profiler
    and chip_smoke.py's scan phases use: K3's carry a fully masked object
    row, and K4's are exactly segment_scan_dot_bwd's tensor arguments (all
    but scale and the route option), built from what the forward keeps, at
    the forward's shapes."""
    import inspect

    from tggcn_torch.ops.segment_scan import segment_scan_dot_bwd
    from tggcn_torch.profile_scan import bwd_inputs, scan_inputs

    t, b, nh, no, h = 4, 3, 2, 3, 8
    gen = torch.Generator().manual_seed(0)
    fwd = scan_inputs(torch.device("cpu"), gen, t, b, nh, no, h)
    assert not fwd["obj_mask"][0].any() and fwd["obj_mask"][1].all()
    bwd = bwd_inputs(fwd, gen, 1.0 / math.sqrt(h))
    assert list(bwd) == [k for k in inspect.signature(segment_scan_dot_bwd).parameters
                         if k not in ("scale", "route")]
    out_h, out_o, att, *kept = segment_scan_dot(**fwd, scale=1.0 / math.sqrt(h))
    for name, x in zip(KEPT, kept):
        if name in bwd:
            torch.testing.assert_close(bwd[name], x, rtol=0, atol=0)
    assert (bwd["g_h"].shape, bwd["g_o"].shape, bwd["g_att"].shape) == (
        out_h.shape, out_o.shape, att.shape)
    grads = segment_scan_dot_bwd(**bwd, scale=1.0 / math.sqrt(h))
    assert all(bool(grads[k].isfinite().all()) for k in BWD_OUTPUTS)


def _tf32(x):
    """x rounded to TF32 by clearing the low 13 bits of its float32 mantissa."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("depth", [512, 1536, 2560])
def test_split_tf32_product_keeps_float32_accuracy(depth):
    """The tensor-core products of K1-K4 (csrc/tc_gemm.cuh) split each
    float32 operand into a TF32 part and a TF32 remainder and take three
    products, lo hi + hi lo + hi hi, in float32. Emulated here at the
    kernels' depths at h = 512 (K1's h; K2's 3h and the scan cell's 2h + h;
    K4's carry, 3h + 2h) on operands of their scale (states in (-1, 1),
    weights ~ h^-1/2): the split stays within 1e-5 of the float64 product, a
    tenth of the kernels' 1e-4 limits, while one TF32 product misses them."""
    rng = np.random.default_rng(depth)
    x = torch.tensor(rng.uniform(-1, 1, size=(32, depth)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, size=(depth, 64)) / math.sqrt(512), dtype=torch.float32)
    exact = x.double() @ w.double()
    x_hi, w_hi = _tf32(x), _tf32(w)
    x_lo, w_lo = _tf32(x - x_hi), _tf32(w - w_hi)
    split = x_lo @ w_hi + x_hi @ w_lo + x_hi @ w_hi
    single = x_hi @ w_hi
    err = lambda y: float((y.double() - exact).abs().max())
    assert err(split) < 1e-5
    assert err(single) > 1e-4



def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
def test_bf16_plain_versions_match_pallas(nh):
    """segment_scan_dot_autograd in bfloat16 (K3's and K4's plain versions)
    against _seg_dir in bfloat16 with fuse_dirs (rows [:B] the forward
    direction, [B:] the backward one on time-flipped inputs): the outputs
    and every gradient within two bfloat16 ulps of its largest value."""
    t, b, no, h = 6, 3, 3, 16
    bf = jnp.bfloat16
    rb = lambda x: np.asarray(jnp.asarray(x, bf).astype(jnp.float32))
    a = {k: rb(v) for k, v in _inputs(t, b, nh, no, h, seed=40 + nh).items()}
    rng = np.random.default_rng(50 + nh)
    scale = 1.0 / math.sqrt(h)
    g = dict(h=rb(rng.normal(size=(2, t, b, nh, h))), o=rb(rng.normal(size=(2, t, b, no, h))),
             att=rb(rng.normal(size=(2, t, b, nh, no))))
    fused = lambda x: np.concatenate([x[0], x[1][::-1]], axis=1)     # (T, 2B, ...)
    both = lambda x: np.concatenate([x, x[::-1]], axis=1)
    args = [fused(a["gi_h"]), fused(a["gi_o"]), both(a["u_h"]), both(a["u_o"]), a["w_from"],
            a["b_from"], a["w_msg_h"], a["w_msg_o"], a["w_hh_h"], a["w_hh_o"], a["b_hh_h"],
            a["b_hh_o"], 1.0 - np.eye(nh, dtype=np.float32),
            np.concatenate([a["obj_mask"]] * 2), 1.0 - np.eye(no, dtype=np.float32),
            np.concatenate(list(a["h0_h"])), np.concatenate(list(a["h0_o"]))]
    out, vjp = jax.vjp(lambda *x: _seg_dir(scale, False, True, True, *x),
                       *[jnp.asarray(x, bf) for x in args])
    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    split = lambda x: np.stack([f32(x)[:, :b], f32(x)[:, b:][::-1]])   # (2, T, B, ...)
    grads = [f32(x) for x in vjp(tuple(jnp.asarray(fused(g[k]), bf) for k in ("h", "o", "att")))]
    want_grads = dict(
        gi_h=np.stack([grads[0][:, :b], grads[0][:, b:][::-1]]),
        gi_o=np.stack([grads[1][:, :b], grads[1][:, b:][::-1]]),
        u_h=grads[2][:, :b] + grads[2][:, b:][::-1], u_o=grads[3][:, :b] + grads[3][:, b:][::-1],
        w_from=grads[4], b_from=grads[5], w_msg_h=grads[6], w_msg_o=grads[7], w_hh_h=grads[8],
        w_hh_o=grads[9], b_hh_h=grads[10], b_hh_o=grads[11],
        h0_h=np.stack([grads[15][:b], grads[15][b:]]), h0_o=np.stack([grads[16][:b],
                                                                     grads[16][b:]]))
    leaves = {k: torch.tensor(v).bfloat16().requires_grad_(k in DIFFERENTIABLE)
              for k, v in a.items()}
    got = segment_scan_dot_autograd(**leaves, scale=scale)
    for name, o, w in zip(("h_h", "h_o", "att_oh"), got, out):
        assert o.dtype == torch.bfloat16, name
        err = np.abs(o.detach().float().numpy() - split(w)).max()
        assert err <= 2 * bf16_ulp(np.abs(split(w)).max()), f"{name}: {err:.3e}"
    torch.autograd.backward(list(got), [torch.tensor(g[k]).bfloat16() for k in ("h", "o", "att")])
    for k in DIFFERENTIABLE:
        gk, w = leaves[k].grad.float().numpy(), want_grads[k]
        assert leaves[k].grad.dtype == torch.bfloat16 and np.isfinite(gk).all(), k
        err = np.abs(gk - w).max()
        assert err <= 2 * bf16_ulp(np.abs(w).max()), f"{k}: {err:.3e}"


@pytest.mark.parametrize("bad", ["gi_h_float32", "kept_m_bfloat16", "float16"])
def test_wrappers_refuse_mixed_dtypes(bad):
    """The wrappers of K3, K4 and K5 take float32 or bfloat16 IO, all of one
    dtype (the kept edge messages, gates and attention float32); the check
    alone takes float32 only; any other mix raises (checked on CPU tensors
    through the check the CUDA route runs)."""
    t, b, nh, no, h = 3, 2, 2, 2, 8
    args = {k: torch.tensor(v).bfloat16() for k, v in _inputs(t, b, nh, no, h, 60).items()}
    dims = (t, b, nh, no, h)
    both = (torch.float32, torch.bfloat16)
    segment_scan_check = lambda a, **kw: scan_ops._check("segment_scan_dot", a, dims, **kw)
    segment_scan_check(args, io_dtypes=both)                      # all bfloat16: accepted
    with pytest.raises(ValueError):
        segment_scan_check(args)                                   # the default: float32
    if bad == "gi_h_float32":
        args["gi_h"] = args["gi_h"].float()
    elif bad == "kept_m_bfloat16":
        args["m_h"] = torch.zeros((2, t, b, nh, 2 * h), dtype=torch.bfloat16)
    else:
        args = {k: v.half() for k, v in args.items()}
    with pytest.raises(ValueError):
        segment_scan_check(args, io_dtypes=both)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_round_carry_rounds_only_a_bf16_carry(dtype):
    """round_carry (the control chip_smoke.py holds the bfloat16 checks to)
    rounds K3's carried states and K4's carried dL/dh to the IO dtype every
    step: the same bits in float32, other values in bfloat16."""
    from tggcn_torch.profile_scan import bwd_inputs, scan_inputs

    t, b, nh, no, h = 5, 2, 2, 3, 8
    gen = torch.Generator().manual_seed(34)
    fwd = {k: v.to(dtype) for k, v in scan_inputs(torch.device("cpu"), gen, t, b, nh, no,
                                                  h).items()}
    scale = 1.0 / math.sqrt(h)
    bwd = bwd_inputs(fwd, gen, scale)
    want = (scan_ops.segment_scan_dot_plain(**fwd, scale=scale),
            scan_ops.segment_scan_dot_bwd_plain(**bwd, scale=scale))
    got = (scan_ops.segment_scan_dot_plain(**fwd, scale=scale, round_carry=True),
           scan_ops.segment_scan_dot_bwd_plain(**bwd, scale=scale, round_carry=True))
    same = (all(torch.equal(a, b) for a, b in zip(got[0], want[0])),
            all(torch.equal(got[1][k], want[1][k]) for k in BWD_OUTPUTS))
    assert same == ((True, True) if dtype == torch.float32 else (False, False))
