"""The segment scan's other attention modes ('v1' concat, 'v4' bilinear,
'ext' for mean pooling and distance-based attention) in bfloat16, and the
port's copy of JAX's XLA fast path, on the CPU against the JAX package.

* K5's plain version in bfloat16 against the Pallas segment kernel in
  bfloat16 (``_seg_dir_pallas``, one direction at a time, interpret mode),
  per mode, with a partly and a fully masked object row: every output
  within two bfloat16 ulps of its largest value. In 'v4' the rounding of
  recv @ W to bfloat16 shows: without it the port lies further from JAX.
  The 'ext' weights (``external_att_weights``) against JAX's in bfloat16,
  within two ulps of 1.
* ``round_carry`` on K5's plain version rounds only a bfloat16 carry.
* ``segment_scan_fast`` (``models/segment_fast.py``) against JAX's
  ``_segment_scan_fast`` in every mode (dot too): rtol 1e-5, atol 1e-6 in
  float32, two bfloat16 ulps of each output's largest in bfloat16; its
  gradients against jax.vjp of JAX's in float32 at rtol 1e-4, atol 1e-5
  (the carried gradient sums over the sequence, as the segment-scan tests
  hold K4).
* ``segment_scan_recompute``: the forward is K5's, the gradients are those
  of ``segment_scan_fast`` at the same inputs, bit for bit.
* Stage 2 in 'v4' (decisions learned for humans and objects and filtered
  to local maxima, the segmentation loss on) trained against JAX as
  tests/test_torch_modes_train.py trains the stage-1 variants: every leaf
  at rtol 1e-3, atol 1e-5; the humans' decision MLP gets its gradient only
  through the scan's decision gradient (du) and the filter.
* A bfloat16 model: distance tensors cast to bfloat16, as JAX casts them;
  the GeoGCN kernel's inputs float32; the 'dist' variant with the GeoGCN
  kernel against JAX's bfloat16 model with its Pallas kernels in interpret
  mode, at tests/test_torch_bf16.py's bounds.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_segment_scan as port_scan_tests
import test_torch_stage2 as stage2_tests
from test_torch_modes_train import _grads, interpret  # noqa: F401 (a fixture)
import tggcn.ops.geo_gcn_pallas as geo_pallas
import tggcn.ops.gru_pallas as gru_pallas
import tggcn.ops.segment_scan_pallas as scan_pallas
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import _segment_scan_fast as jax_segment_scan_fast
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn.ops.segment_scan_pallas import _external_att_weights, _seg_dir_pallas
import tggcn_torch.models.tggcn as port_model
import tggcn_torch.ops.segment_scan as scan_ops
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.models import stage1, stage2
from tggcn_torch.models.registry import select_model
from tggcn_torch.models.segment_fast import segment_scan_fast
from tggcn_torch.models.tggcn import (TGGCNConfig, cast_params_for_compute,
                                      external_att_weights, segment_mode)
from tggcn_torch.ops.segment_scan import segment_scan_att_plain, segment_scan_recompute
from tggcn_torch.train.loop import model_parameters

BF = jnp.bfloat16
MODES = ["v1", "v4", "ext_dist", "ext_mp"]
SCAN = dict(port_scan_tests.SCAN_CONFIG)
FAST_VARIANTS = {"v3": {}, "v1": dict(attention_style="v1"), "v4": dict(attention_style="v4"),
                 "mp": dict(message_aggregation="mp"), "dist": {}}


def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _rb(x):
    """x rounded to bfloat16, as float32 numpy."""
    return np.asarray(jnp.asarray(x, BF).astype(jnp.float32))


def _within_ulps(got, want, ulps, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= ulps * bf16_ulp(np.abs(want).max()), f"{what}: {err:.3e}"
    return err


def _k5_case(mode, nh, seed, att_scale=1.0):
    """Seeded bfloat16 inputs of one K5 mode (float32 arrays of bfloat16
    values): the scan inputs, and the mode's extra inputs for JAX's kernel
    and for the port."""
    t, b, no, h = 6, 3, 3, 16
    a = {k: _rb(v) for k, v in port_scan_tests._inputs(t, b, nh, no, h, seed).items()}
    rng = np.random.default_rng(seed + 100)
    if mode in ("v1", "v4"):
        shape = (4, 2 * h, 1) if mode == "v1" else (4, h, h)
        w_att = _rb(rng.uniform(-1, 1, size=shape) * att_scale / math.sqrt(h))
        b_att = _rb(rng.uniform(-0.5, 0.5, size=(4, 1)))
        jax_extra = dict(w_att=jnp.asarray(w_att, BF), b_att=jnp.asarray(b_att, BF))
        port_extra = dict(w_att=torch.tensor(w_att.reshape(4, -1) if mode == "v1" else w_att),
                          b_att=torch.tensor(b_att[:, 0]))
    else:
        cfg = SimpleNamespace(message_aggregation="mp" if mode == "ext_mp" else "att")
        dists3 = [_rb(d) for d in port_scan_tests._distances(rng, b, t, nh, no)]
        want = _external_att_weights(cfg, [jnp.asarray(d, BF) for d in dists3],
                                     jnp.asarray(a["obj_mask"], BF), b, t, nh, no, BF)
        got = external_att_weights(mode == "ext_mp",
                                   [torch.tensor(d).bfloat16() for d in dists3],
                                   torch.tensor(a["obj_mask"]).bfloat16(), t, nh)
        packed = port_scan_tests._pack([np.asarray(w.astype(jnp.float32)) for w in want], nh)
        assert got.dtype == torch.bfloat16
        _within_ulps(got.float().numpy(), packed, 2, "ext weights")
        jax_extra = dict(att_ws=tuple(want))
        port_extra = dict(att_ext=torch.tensor(packed))
    return a, jax_extra, port_extra


def _jax_k5(mode, a, jax_extra, nh):
    """JAX's kernel in bfloat16, both directions, as (2, T, ...) float32."""
    no = a["gi_o"].shape[3]
    outs = []
    for d, reverse in ((0, False), (1, True)):
        args = [a["gi_h"][d], a["gi_o"][d], a["u_h"], a["u_o"], a["w_from"], a["b_from"],
                a["w_msg_h"][d], a["w_msg_o"][d], a["w_hh_h"][d], a["w_hh_o"][d],
                a["b_hh_h"][d], a["b_hh_o"][d], 1.0 - np.eye(nh, dtype=np.float32),
                a["obj_mask"], 1.0 - np.eye(no, dtype=np.float32), a["h0_h"][d], a["h0_o"][d]]
        outs.append(_seg_dir_pallas(*[jnp.asarray(x, BF) for x in args], scale=1.0,
                                    reverse=reverse, interpret=True, mode=mode[:3],
                                    **jax_extra))
    return [np.stack([np.asarray(o[i].astype(jnp.float32)) for o in outs]) for i in range(3)]


def _port_k5(mode, a, port_extra, **kw):
    args = {k: torch.tensor(v).bfloat16() for k, v in a.items()}
    extra = {k: v.bfloat16() for k, v in port_extra.items()}
    return segment_scan_att_plain(mode[:3], **args, **extra, **kw)


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
@pytest.mark.parametrize("mode", MODES)
def test_k5_bf16_plain_matches_pallas(mode, nh):
    a, jax_extra, port_extra = _k5_case(mode, nh, seed=70 + nh)
    want = _jax_k5(mode, a, jax_extra, nh)
    got = _port_k5(mode, a, port_extra)
    for name, g, w in zip(("h_h", "h_o", "att_oh"), got, want):
        assert g.dtype == torch.bfloat16, name
        _within_ulps(g.float().numpy(), w, 2, name)
    assert not got[2][:, :, -1].any()           # the batch row with every object masked


def test_k5_bf16_v4_rounds_the_bilinear_product(monkeypatch):
    """Scores large enough that rounding recv @ W to bfloat16 moves the
    outputs: the port with the rounding lies within two ulps of JAX and
    closer to it than the port without."""
    a, jax_extra, port_extra = _k5_case("v4", 2, seed=80, att_scale=8.0)
    want = _jax_k5("v4", a, jax_extra, 2)

    def gaps(got):
        return [float(np.abs(g.float().numpy() - w).sum()) for g, w in zip(got, want)]

    got = _port_k5("v4", a, port_extra)
    for name, g, w in zip(("h_h", "h_o", "att_oh"), got, want):
        _within_ulps(g.float().numpy(), w, 2, name)
    monkeypatch.setattr(scan_ops, "_v4_scores", lambda q, w_att, b_att: (
        lambda recv, send, e: torch.relu((q(recv) @ w_att[e]) @ send.transpose(-1, -2)
                                         + b_att[e])))
    unrounded = _port_k5("v4", a, port_extra)
    assert sum(gaps(unrounded)) > 2 * sum(gaps(got)), (gaps(unrounded), gaps(got))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_k5_round_carry_rounds_only_a_bf16_carry(mode, dtype):
    """round_carry (the control of chip_smoke.py's k5 bfloat16 checks)
    rounds K5's carried states every step: the same bits in float32, other
    values in bfloat16."""
    a, _, port_extra = _k5_case(mode, 2, seed=90)
    args = {k: torch.tensor(v).to(dtype) for k, v in a.items()}
    extra = {k: v.to(dtype) for k, v in port_extra.items()}
    want = segment_scan_att_plain(mode[:3], **args, **extra)
    got = segment_scan_att_plain(mode[:3], **args, **extra, round_carry=True)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    assert same == (dtype == torch.float32)


def _fast_case(variant, dtype, seed=7):
    """JAX's and the port's parameters and inputs of segment_scan_fast in
    the variant ('dist': dot attention with three distance tensors), all
    of bfloat16 values in bfloat16."""
    kwargs = dict(SCAN, **FAST_VARIANTS[variant])
    jax_cfg = JaxConfig.from_kwargs(**kwargs)
    jax_params = jax_init(jax.random.PRNGKey(1), jax_cfg)
    b, t, nh, no, h = 2, 5, 2, 3, 8
    rng = np.random.default_rng(seed)
    arrays = dict(x_hs=rng.normal(size=(b, t, nh, 3 * h)), x_os=rng.normal(size=(b, t, no, 4 * h)),
                  u_h=rng.uniform(size=(b, t, nh)), u_o=rng.uniform(size=(b, t, no)))
    mask = np.ones((b, no), np.float32)
    mask[0, 1] = 0.0
    mask[1] = 0.0
    dists = (port_scan_tests._distances(rng, b, t, nh, no) if variant == "dist"
             else (None,) * 3)
    bf16 = dtype == torch.bfloat16
    cast = _rb if bf16 else (lambda x: np.asarray(x, np.float32))
    jdt = BF if bf16 else jnp.float32
    arrays = {k: cast(v) for k, v in arrays.items()}
    dists = [None if d is None else cast(d) for d in dists]
    np_params = jax.tree_util.tree_map(lambda x: cast(np.asarray(x)), jax_params)
    jax_args = dict(params=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), np_params),
                    **{k: jnp.asarray(v, jdt) for k, v in arrays.items()},
                    mask=jnp.asarray(mask, jdt),
                    dists=[None if d is None else jnp.asarray(d, jdt) for d in dists])
    params = params_from_numpy(np_params)
    if bf16:
        params = cast_params_for_compute(params, torch.bfloat16)
    port_args = dict(params=params, **{k: torch.tensor(v).to(dtype) for k, v in arrays.items()},
                     mask=torch.tensor(mask).to(dtype),
                     dists=[None if d is None else torch.tensor(d).to(dtype) for d in dists])
    return jax_cfg, TGGCNConfig.from_kwargs(**kwargs), jax_args, port_args


def _jax_fast(cfg, p, x_hs, x_os, u_h, u_o, mask, dists):
    return jax_segment_scan_fast(p, cfg, x_hs, x_os, u_h, u_o, mask, *dists)


def _port_fast(cfg, p, x_hs, x_os, u_h, u_o, mask, dists):
    return segment_scan_fast(p, cfg, x_hs, x_os, u_h, u_o, mask, *dists)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(FAST_VARIANTS))
def test_fast_path_matches_jax(variant, dtype):
    jax_cfg, cfg, ja, pa = _fast_case(variant, dtype)
    want = _jax_fast(jax_cfg, ja["params"], ja["x_hs"], ja["x_os"], ja["u_h"], ja["u_o"],
                     ja["mask"], ja["dists"])
    with torch.no_grad():
        got = _port_fast(cfg, pa["params"], pa["x_hs"], pa["x_os"], pa["u_h"], pa["u_o"],
                         pa["mask"], pa["dists"])
    for name, g, w in zip(("hx_hs", "hx_os", "att_fwd", "att_bwd"), got, want):
        assert g.dtype == dtype, name
        w = np.asarray(w.astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            _within_ulps(g.float().numpy(), w, 2, name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("variant", list(FAST_VARIANTS))
def test_fast_path_gradients_match_jax(variant):
    """Gradients of every parameter the scan reads, the inputs, the
    decisions (what stage 2's straight-through estimator reads) and the
    distances, for random cotangents on all four outputs."""
    jax_cfg, cfg, ja, pa = _fast_case(variant, torch.float32, seed=8)
    names = ["x_hs", "x_os", "u_h", "u_o"]
    dist_idx = [i for i, d in enumerate(ja["dists"]) if d is not None]

    def jax_fn(p, xh, xo, uh, uo, ds):
        dists = list(ja["dists"])
        for i, d in zip(dist_idx, ds):
            dists[i] = d
        return _jax_fast(jax_cfg, p, xh, xo, uh, uo, ja["mask"], dists)

    out, vjp = jax.vjp(jax_fn, ja["params"], *(ja[k] for k in names),
                       [ja["dists"][i] for i in dist_idx])
    rng = np.random.default_rng(9)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in out]
    if variant == "mp":
        cots[2:] = [np.zeros_like(c) for c in cots[2:]]
    want_p, *want_x, want_d = vjp(tuple(jnp.asarray(c) for c in cots))

    leaves = {k: v.requires_grad_(True) for k, v in _flat(pa["params"]).items()}
    xs = [pa[k].requires_grad_(True) for k in names]
    ds = [pa["dists"][i].requires_grad_(True) for i in dist_idx]
    got = _port_fast(cfg, pa["params"], *xs, pa["mask"], pa["dists"])
    pairs = [(g, torch.tensor(c)) for g, c in zip(got, cots) if g.requires_grad]
    torch.autograd.backward([g for g, _ in pairs], [c for _, c in pairs])
    for k, w in _flat(jax.tree_util.tree_map(np.asarray, want_p)).items():
        g = leaves[k].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=k)
    for name, x, w in [*zip(names, xs, want_x), *zip(["dists"] * 3, ds, want_d)]:
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(xs[2].grad.abs().max()) > 0         # the decisions get a gradient


@pytest.mark.parametrize("variant", ["v4", "dist"])
def test_recompute_takes_the_fast_path_gradients(variant):
    """Through the model's scan (K5's plain version forward, the recompute
    backward): the outputs are K5's, the gradients segment_scan_fast's at
    the same inputs, bit for bit."""
    _, cfg, _, pa = _fast_case(variant, torch.float32, seed=10)
    mode = segment_mode(cfg, pa["dists"])
    rng = np.random.default_rng(11)

    def run(scan):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _flat(pa["params"]).items()}
        params = port_model.flatten(pa["params"])[1](list(leaves.values()))
        xs = [pa[k].detach().clone().requires_grad_(True) for k in ("x_hs", "x_os", "u_h", "u_o")]
        dists = [None if d is None else d.detach().clone().requires_grad_(True)
                 for d in pa["dists"]]
        out = scan(params, *xs, dists)
        cots = [torch.tensor(rng.normal(size=o.shape), dtype=torch.float32) for o in out]
        torch.autograd.backward(list(out), cots)
        grads = [x.grad for x in [*leaves.values(), *xs, *dists]
                 if x is not None and x.grad is not None]
        return [o.detach() for o in out], grads

    rng = np.random.default_rng(11)
    got, got_grads = run(lambda p, xh, xo, uh, uo, d: port_model._segment_scan_fast(
        p, cfg, mode, xh, xo, uh, uo, pa["mask"], d))
    rng = np.random.default_rng(11)
    want, want_grads = run(lambda p, xh, xo, uh, uo, d: segment_scan_fast(
        p, cfg, xh, xo, uh, uo, pa["mask"], *d))
    with torch.no_grad():
        k5 = port_model._k5_scan(pa["params"], cfg, mode, pa["x_hs"], pa["x_os"], pa["u_h"],
                                 pa["u_o"], pa["mask"], pa["dists"], use_kernels=True)
    assert all(torch.equal(g, k) for g, k in zip(got, k5))
    assert len(got_grads) == len(want_grads) > 0
    assert all(torch.equal(g, w) for g, w in zip(got_grads, want_grads))


def test_recompute_runs_alone_without_grad():
    """Without a gradient to take, segment_scan_recompute is run alone: no
    autograd Function, and recompute is never called."""
    called = []
    x = torch.ones(3)
    out = segment_scan_recompute(lambda a: (a * 2,), lambda a: called.append(1), x)
    assert out[0].grad_fn is None and not called


# --- A bfloat16 model ------------------------------------------------------

KW = dict(stage1.MODEL_KWARGS, hidden_size=16, discrete_optimization_strategy="st")


def test_bf16_model_casts_the_distances(monkeypatch):
    """JAX casts the three distance tensors to the compute dtype
    (tggcn/models/tggcn.py:483-485): the frame messages and the segment
    weights read them in bfloat16."""
    seen = []
    weights, messages = port_model.external_att_weights, port_model.compute_message_features
    monkeypatch.setattr(port_model, "external_att_weights", lambda mp, dists3, *a: (
        seen.extend(d.dtype for d in dists3), weights(mp, dists3, *a))[1])
    monkeypatch.setattr(port_model, "compute_message_features", lambda *a, distances=None, **k: (
        seen.append(distances.dtype if distances is not None else None),
        messages(*a, distances=distances, **k))[1])
    model = select_model("2G-GCN", device="cpu", **dict(KW, compute_dtype="bfloat16"))
    rng = np.random.default_rng(0)
    batch = stage1.make_request(rng, 2, 4, 2, 3)
    out, _ = model.apply(model.init(torch.Generator().manual_seed(0)), **batch,
                         **stage1.make_distances(rng, 2, 4, 2, 3))
    assert all(bool(torch.isfinite(o).all()) for o in out)
    # The frame messages h2h, o2h, h2o, s2o (no distances), o2o; then the
    # segment weights of hh, ho, oo.
    assert seen == [torch.bfloat16] * 3 + [None] + [torch.bfloat16] * 4, seen


def test_bf16_model_runs_geo_gcn_kernel_in_float32(monkeypatch):
    """JAX keeps the GeoGCN block float32 in a bfloat16 model: the port's
    GeoGCN kernel (K6) takes float32 geometry and weights, serving and
    training."""
    import tggcn_torch.nn.geo_gcn as geo

    dtypes = []
    fused = geo.geo_gcn_fused_autograd
    monkeypatch.setattr(geo, "geo_gcn_fused_autograd", lambda *a, **k: (
        dtypes.append({x.dtype for x in a}), fused(*a, **k))[1])
    model = select_model("2G-GCN", device="cpu", **dict(KW, compute_dtype="bfloat16",
                                                        use_pallas_geo_gcn=True))
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = dict(stage1.make_request(rng, 2, 4, 2, 3), **stage1.make_distances(rng, 2, 4, 2, 3))
    model.apply(params, **batch)
    for p in model_parameters(params):
        p.requires_grad_(True)
    out, _ = model.apply(params, train=True, **batch)
    sum(o.mean() for o in out[2:]).backward()
    assert dtypes == [{torch.float32}] * 2
    gcn = params["geometry_embedding_gcn"]
    grad = gcn["embed1"]["w"].grad
    assert grad is not None and bool(torch.isfinite(grad).all())


def test_bf16_dist_variant_with_geo_gcn_matches_jax(monkeypatch):
    """The 'dist' serving variant (the GeoGCN kernel on, distance-based
    attention) in bfloat16 against JAX's bfloat16 model with its Pallas
    kernels (BiGRU, segment scan in 'ext' mode, GeoGCN) in interpret mode:
    the log-probability heads within 1e-2 absolute, mean below 0.05, as
    tests/test_torch_bf16.py holds the dot route. Random segmentations are
    imposed for humans and objects: at hidden 16 the soft decisions of a
    random init lie within a few bfloat16 ulps of the threshold, where
    either rounding is right and a flipped decision changes a whole
    segment."""
    run_gru, run_scan = gru_pallas.run_multi_bigru_pallas, scan_pallas.run_segment_scan_pallas
    fused = geo_pallas.geo_gcn_fused
    monkeypatch.setattr(gru_pallas, "run_multi_bigru_pallas",
                        lambda *a, **kw: run_gru(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(scan_pallas, "run_segment_scan_pallas",
                        lambda *a, **kw: run_scan(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(geo_pallas, "geo_gcn_fused", lambda *a: fused(*a, 16, True))
    kwargs = dict(KW, compute_dtype="bfloat16", **stage1.SERVE_VARIANTS["dist"])
    params = jax_init(jax.random.PRNGKey(0), JaxConfig.from_kwargs(**kwargs))
    rng = np.random.default_rng(3)
    b, t, nh, no = 2, 8, 2, 3
    segmentation = lambda n: np.where(np.arange(t)[None, :, None] == t - 1, 1.0, (
        rng.uniform(size=(b, t, n)) < 0.4)).astype(np.float32)
    batch = dict(x_human=rng.normal(size=(b, t, nh, 2152)).astype(np.float32),
                 x_objects=rng.normal(size=(b, t, no, 2048)).astype(np.float32),
                 objects_mask=np.ones((b, no), np.float32),
                 human_segmentation=segmentation(nh), objects_segmentation=segmentation(no),
                 **stage1.make_distances(rng, b, t, nh, no))
    batch["objects_mask"][1, -1] = 0.0
    cfg = JaxConfig.from_kwargs(use_pallas_gru=True, use_pallas_segment_scan=True,
                                segment_kernel_modes="all", **kwargs)
    want, _ = jax_apply(params, cfg, train=False, rng=jax.random.PRNGKey(7), **batch)
    model = select_model("2G-GCN", device="cpu", **kwargs)
    got, _ = model.apply(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)), **batch)
    assert all(o.dtype == torch.float32 for o in got)
    for i in range(2, 6):
        d = np.abs(got[i].numpy() - np.asarray(want[i]))
        assert d.max() < 1e-2 and d.mean() < 0.05, f"head {i}: max {d.max()}, mean {d.mean()}"


def test_stage2_mode_gradients_match_jax(interpret):
    """Stage 2 in 'v4' at tests/test_torch_stage2.py's shape and batch."""
    kwargs = dict(stage2.MODEL_KWARGS, hidden_size=16, attention_style="v4")
    want_total, total, want, got = _grads(kwargs, stage2_tests._batch(seed=2),
                                          dict(stage2_tests.FEEDER), stage2_tests.MISC,
                                          stage2_tests._noise("gs"))
    np.testing.assert_allclose(total, want_total, rtol=1e-5)
    # The humans' decisions are learned: their MLP's gradient comes through
    # the filter's straight-through term from the scan's du_h.
    assert float(got["/update_human_segment_mlp/layers/0/w"].abs().max()) > 0
    for k, w in want.items():
        g = got[k].numpy() if k in got else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)
