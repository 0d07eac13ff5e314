"""The arithmetic of the redesigned K5 score phases and K6, emulated in
plain PyTorch on the CPU, against the JAX package (its Pallas kernels in
interpret mode, and its XLA reference).

* K5 'v4' (csrc/segment_scan.cu, proj_v4_kernel): each step's bilinear
  scores summed from per-32-column partial scores in column order, tmp =
  recv @ W rounded to the IO dtype element by element before the partials
  take the float32 sender states. In float32 the scan with these scores
  against ``_seg_dir_pallas(mode="v4")``: rtol 1e-5, atol 1e-6, as
  tests/test_torch_segment_scan.py holds K5's plain version; at hidden 24,
  40 and 64 (one ragged 32-column block, a ragged last block, whole
  blocks), one and two humans, a fully masked object row. In bfloat16 the
  scores against JAX's ``scores_v4`` arithmetic within one bfloat16 ulp of
  the largest score, and the scan against the Pallas kernel in bfloat16
  within two bfloat16 ulps of each output's largest value (as
  tests/test_torch_modes.py holds K5's plain bfloat16 version).
* K5 'v1': the four projections made once per entity (a (2, B, E, 4)
  buffer, each a dot product in the kernel's lane order) and the scores
  read from them, in the scan against the Pallas kernel (float32 rtol
  1e-5, atol 1e-6) and against ``_v1_scores``.
* K6 (csrc/geo_gcn.cu): one warp a frame, FRAMES_PER_BLOCK frames a block
  at a time over min(N, 132) blocks, V padded to 32 rows, every product in
  the 3xTF32 split (tests/test_torch_segment_scan.py's
  test_split_tf32_product_keeps_float32_accuracy), the softmax over the V
  real columns: every frame run once, against JAX's ``geo_gcn_reference``
  and its Pallas ``geo_gcn_fused`` in interpret mode at 1e-5.
* The wrappers' score scratch shapes and the shapes the wrappers refuse.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_segment_scan as port_scan_tests
from tggcn.ops.geo_gcn_pallas import geo_gcn_fused, geo_gcn_reference
from tggcn.ops.segment_scan_pallas import _seg_dir_pallas
import tggcn_torch.ops.geo_gcn as geo_ops
import tggcn_torch.ops.segment_scan as scan_ops
from tggcn_torch.ops import _build

RTOL, ATOL = 1e-5, 1e-6
BF = jnp.bfloat16
SMS = 132                       # the H100's SMs: the grid of K6 at N >= 132


def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _rb(x):
    """x rounded to bfloat16, as float32 numpy."""
    return np.asarray(jnp.asarray(x, BF).astype(jnp.float32))


# --- K5 -------------------------------------------------------------------


def _v4_partial_scores(q, w_att, b_att, h):
    """proj_v4_kernel's scores: tmp = q(q(recv) @ W) and, per 32-column
    block, the partial sum over the block's columns of tmp against the
    float32 sender states; the mix phase adds the partials in column
    order."""
    blocks = range(0, h, scan_ops.V4_PART_COLUMNS)

    def scores(recv, send, e):
        tmp = q(q(recv) @ w_att[e])
        total = None
        for c in blocks:
            part = (tmp[..., c:c + scan_ops.V4_PART_COLUMNS]
                    @ send[..., c:c + scan_ops.V4_PART_COLUMNS].transpose(-1, -2))
            total = part if total is None else total + part
        return torch.relu(total + b_att[e])
    return scores


def _lane_dot(x, w):
    """A dot product over the last axis as v1_projections takes it: lane l
    sums four neighbouring values of every 128 from l * 4, then the 32
    lanes' sums meet in a shuffle tree (offsets 16, 8, 4, 2, 1)."""
    h = x.shape[-1]
    lanes = []
    for lane in range(32):
        acc = torch.zeros(x.shape[:-1], dtype=torch.float32)
        for k in range(4 * lane, h, 128):
            for i in range(4):
                acc = acc + x[..., k + i] * w[k + i]
        lanes.append(acc)
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i + off] if i < off else lanes[i] for i in range(32)]
    return lanes[0]


def _v1_projection_scores(q, w_att, b_att, nh):
    """The v1 scores from the per-entity projections: proj[n][j] for j < 2
    takes n as the receiver of senders of group j (w_att[2 g + j]'s first
    half), for j >= 2 as the sender to receivers of group j - 2 (w_att[2
    (j - 2) + g]'s second half), each made once; score(n, m) = relu(proj[n]
    [g_m] + proj[m][2 + g_n] + b_att[2 g_n + g_m])."""
    h = w_att.shape[1] // 2

    def proj(states, g):
        x = q(states)
        rows = [w_att[2 * g, :h], w_att[2 * g + 1, :h], w_att[g, h:], w_att[2 + g, h:]]
        return torch.stack([_lane_dot(x, w) for w in rows], dim=-1)       # (2, B, N, 4)

    def scores(recv, send, e):
        g_recv, g_send = divmod(e, 2)
        p_recv = proj(recv, g_recv)
        p_send = proj(send, g_send)
        return torch.relu(p_recv[..., :, None, g_send] + p_send[..., None, :, 2 + g_recv]
                          + b_att[e])
    return scores


def _scan_with(scores, a, dtype=torch.float32):
    """K5's plain scan on the inputs a (numpy) in dtype, its attention from
    scores(recv, send, e)."""
    args = {k: torch.tensor(v).to(dtype) for k, v in a.items()}
    mask = _build.upcast(args.pop("obj_mask"))
    return scan_ops._scan_plain(
        **args, attention=lambda h_h, h_o, ts: scan_ops._attention(h_h, h_o, mask, scores),
        keep=False)


def _pallas(a, mode, nh, dtype=jnp.float32, **extra):
    """_seg_dir_pallas in interpret mode, both directions, as (2, T, ...)
    float32 numpy."""
    no = a["gi_o"].shape[3]
    outs = []
    for d, reverse in ((0, False), (1, True)):
        args = [a["gi_h"][d], a["gi_o"][d], a["u_h"], a["u_o"], a["w_from"], a["b_from"],
                a["w_msg_h"][d], a["w_msg_o"][d], a["w_hh_h"][d], a["w_hh_o"][d],
                a["b_hh_h"][d], a["b_hh_o"][d], 1.0 - np.eye(nh, dtype=np.float32),
                a["obj_mask"], 1.0 - np.eye(no, dtype=np.float32), a["h0_h"][d], a["h0_o"][d]]
        outs.append(_seg_dir_pallas(*[jnp.asarray(x, dtype) for x in args], scale=1.0,
                                    reverse=reverse, interpret=True, mode=mode,
                                    **{k: jnp.asarray(v, dtype) for k, v in extra.items()}))
    return [np.stack([np.asarray(o[i].astype(jnp.float32)) for o in outs]) for i in range(3)]


def _att_case(mode, nh, h, seed, rounded=False):
    """Scan inputs (T=4, B=3, 3 objects, the last batch row's objects all
    masked) and the mode's w_att (JAX's layout: (4, 2h, 1) in v1, (4, h, h)
    in v4) and b_att (4, 1), as float32 numpy (of bfloat16 values when
    rounded)."""
    a = port_scan_tests._inputs(4, 3, nh, 3, h, seed)
    rng = np.random.default_rng(seed + 1)
    shape = (4, 2 * h, 1) if mode == "v1" else (4, h, h)
    w_att = rng.uniform(-1, 1, size=shape).astype(np.float32) * 2.0 / math.sqrt(h)
    b_att = rng.uniform(-0.5, 0.5, size=(4, 1)).astype(np.float32)
    if rounded:
        a = {k: _rb(v) for k, v in a.items()}
        w_att, b_att = _rb(w_att), _rb(b_att)
    return a, w_att, b_att


def _close(got, want, what):
    for name, g, w in zip(("h_h", "h_o", "att_oh"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
@pytest.mark.parametrize("h", [24, 40, 64])
def test_v4_partial_scores_match_pallas(h, nh):
    """The scan with v4's scores summed from 32-column partials, float32,
    against the Pallas kernel; the wrapper's scratch holds one partial per
    block."""
    a, w_att, b_att = _att_case("v4", nh, h, seed=10 * h + nh)
    assert scan_ops.score_scratch_shape("v4", 3, nh, 3, h)[-1] == len(
        range(0, h, scan_ops.V4_PART_COLUMNS)) == math.ceil(h / 32)
    want = _pallas(a, "v4", nh, w_att=w_att, b_att=b_att)
    scores = _v4_partial_scores(lambda x: x, torch.tensor(w_att), torch.tensor(b_att[:, 0]), h)
    got = _scan_with(scores, a)
    _close(got, want, f"v4 partial scores, h {h}")
    assert not got[2][:, :, -1].any()           # the batch row with every object masked


def _jax_scores_v4(recv, send, wa, b):
    """scores_v4 of segment_scan_pallas.py:134-143, on (B, R, h) receivers
    and (B, S, h) senders (float32), wa (h, h) and b in bfloat16."""
    bsz, nr, hd = recv.shape
    tmp = jnp.dot(recv.reshape(bsz * nr, hd).astype(wa.dtype), wa,
                  preferred_element_type=jnp.float32).reshape(bsz, nr, hd)
    s = jax.lax.dot_general(tmp.astype(wa.dtype), send,
                            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32)
    return jnp.maximum(s + b.astype(jnp.float32), 0.0)


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
@pytest.mark.parametrize("h", [24, 40, 64])
def test_v4_partial_scores_bf16(h, nh):
    """In bfloat16: the partial scores (tmp rounded to bfloat16 element by
    element, then against the float32 senders) within one bfloat16 ulp of
    the largest of JAX's scores, on random states of every score edge; and
    the scan with them against the Pallas kernel in bfloat16 within two
    ulps of each output's largest value."""
    rng = np.random.default_rng(h + nh)
    q = _build.rounding(torch.bfloat16)
    a, w_att, b_att = _att_case("v4", nh, h, seed=20 * h + nh, rounded=True)
    w_t, b_t = torch.tensor(w_att), torch.tensor(b_att[:, 0])
    scores = _v4_partial_scores(q, w_t, b_t, h)
    sizes = (nh, 3)
    for e in range(4):
        recv = rng.normal(size=(3, sizes[e // 2], h)).astype(np.float32)
        send = rng.normal(size=(3, sizes[e % 2], h)).astype(np.float32)
        want = np.asarray(_jax_scores_v4(jnp.asarray(recv), jnp.asarray(send),
                                         jnp.asarray(w_att[e], BF), jnp.asarray(b_att[e], BF)))
        got = scores(torch.tensor(recv), torch.tensor(send), e).numpy()
        err = np.abs(got - want).max()
        assert err <= bf16_ulp(np.abs(want).max()), f"edge {e}: {err:.3e}"
    want = _pallas(a, "v4", nh, BF, w_att=w_att, b_att=b_att)
    got = _scan_with(scores, a, torch.bfloat16)
    for name, g, w in zip(("h_h", "h_o", "att_oh"), got, want):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2 * bf16_ulp(np.abs(w).max()), f"{name}: {err:.3e}"


@pytest.mark.parametrize("nh", [2, 1], ids=["two_humans", "one_human"])
@pytest.mark.parametrize("h", [24, 64])
def test_v1_projections_once_per_entity(h, nh):
    """The scan with v1's scores read from per-entity projections, each a
    dot product in the kernel's lane order, against the Pallas kernel
    (float32) and, score by score, against _v1_scores."""
    a, w_att, b_att = _att_case("v1", nh, h, seed=30 * h + nh)
    assert scan_ops.score_scratch_shape("v1", 3, nh, 3, h) == (2, 3, nh + 3, 4)
    w_t, b_t = torch.tensor(w_att.reshape(4, -1)), torch.tensor(b_att[:, 0])
    ident = lambda x: x
    scores = _v1_projection_scores(ident, w_t, b_t, nh)
    plain = scan_ops._v1_scores(ident, w_t, b_t)
    rng = np.random.default_rng(h)
    sizes = (nh, 3)
    for e in range(4):
        recv = torch.tensor(rng.normal(size=(2, 3, sizes[e // 2], h)).astype(np.float32))
        send = torch.tensor(rng.normal(size=(2, 3, sizes[e % 2], h)).astype(np.float32))
        torch.testing.assert_close(scores(recv, send, e), plain(recv, send, e), rtol=RTOL,
                                   atol=ATOL)
    want = _pallas(a, "v1", nh, w_att=w_att, b_att=b_att)
    _close(_scan_with(scores, a), want, f"v1 projections, h {h}")


@pytest.mark.parametrize("mode,want", [("v1", (2, 8, 6, 4)), ("v4", (2, 8, 6, 6, 16)),
                                       ("ext", None)])
def test_k5_score_scratch_shapes(mode, want):
    """The score scratch of each mode at the MPHOI shape (B=8, 2 humans, 4
    objects, h=512): v1 four projections an entity, v4 one partial score a
    32-column block (16 at h=512, 2 at h=40), ext none."""
    assert scan_ops.score_scratch_shape(mode, 8, 2, 4, 512) == want
    if mode == "v4":
        assert scan_ops.score_scratch_shape(mode, 8, 2, 4, 40)[-1] == 2


# --- K6 -------------------------------------------------------------------


def _tf32(x):
    """x rounded to TF32 by clearing the low 13 bits of its float32 mantissa."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split3(a, b):
    """a @ b as the 3xTF32 split takes it: lo hi + hi lo + hi hi in float32,
    lo the float32 remainder read as TF32 by the tensor core."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated_frame(x, w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out):
    """One warp's frame: V rows padded to 32 (x zero past V), every
    product split, the softmax over the V real columns only."""
    v = x.shape[0]
    xp = torch.zeros((32, 4))
    xp[:v] = x
    h = torch.relu(_split3(torch.relu(_split3(xp, w1) + b1), w2) + b2)
    s1, s2 = _split3(h, ws1) + bs1, _split3(h, ws2) + bs2
    scores = _split3(s1, s2.T)
    scores[:, v:] = -math.inf
    mixed = _split3(torch.softmax(scores, dim=-1), h)
    return _split3(mixed, w_out)[:v]


def _emulated_geo_gcn(x, weights, sms=SMS):
    """geo_gcn_kernel's schedule: min(N, sms) blocks of FRAMES_PER_BLOCK
    warps, warp w of block b taking frames w * blocks + b + i *
    FRAMES_PER_BLOCK * blocks. Returns the outputs and how often each frame
    was taken."""
    n = x.shape[0]
    blocks = min(n, sms)
    out = torch.full((n, x.shape[1], 128), math.nan)
    taken = np.zeros(n, int)
    for block in range(blocks):
        for warp in range(geo_ops.FRAMES_PER_BLOCK):
            for f in range(warp * blocks + block, n, geo_ops.FRAMES_PER_BLOCK * blocks):
                out[f] = _emulated_frame(x[f], *weights)
                taken[f] += 1
    return out, taken


F = geo_ops.FRAMES_PER_BLOCK


@pytest.mark.parametrize("v", [1, 5, 26, 32])
@pytest.mark.parametrize("n", [1, F - 1, F + 1, 37])
def test_geo_gcn_tiling_matches_jax(n, v):
    """K6's schedule and arithmetic against JAX's reference and its Pallas
    kernel (16-frame tiles, interpret mode) at 1e-5; every frame taken
    once."""
    rng = np.random.default_rng(100 * n + v)
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128)]
    weights = [rng.uniform(-1, 1, size=s).astype(np.float32) / math.sqrt(s[0]) for s in shapes]
    x = rng.normal(size=(n, v, 4)).astype(np.float32)
    got, taken = _emulated_geo_gcn(torch.tensor(x), [torch.tensor(w) for w in weights])
    assert (taken == 1).all()
    want_ref = np.asarray(geo_gcn_reference(jnp.asarray(x), *map(jnp.asarray, weights)))
    want_pallas = np.asarray(geo_gcn_fused(jnp.asarray(x), *map(jnp.asarray, weights),
                                           tile_n=16, interpret=True))
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        geo_ops.geo_gcn_plain(torch.tensor(x), *[torch.tensor(w) for w in weights]).numpy(),
        want_ref, rtol=1e-5, atol=1e-5)


def test_geo_gcn_schedule_spreads_frames():
    """At the MPHOI shape (N = 8 * 167 = 1336) the 132 blocks take 10 or 11
    frames each and no warp takes two; past 132 * FRAMES_PER_BLOCK frames
    warps take more."""
    def per_warp(n):
        blocks = min(n, SMS)
        return [[len(range(w * blocks + b, n, F * blocks)) for w in range(F)]
                for b in range(blocks)]
    counts = per_warp(1336)
    assert {sum(c) for c in counts} == {10, 11} and max(max(c) for c in counts) == 1
    assert max(max(c) for c in per_warp(SMS * F + 1)) == 2


# --- what the wrappers refuse ---------------------------------------------


def _geo_args(n, v, c_in=4):
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128)]
    return torch.zeros((n, v, c_in)), [torch.zeros(s) for s in shapes]


@pytest.mark.parametrize("v,c_in", [(33, 4), (0, 4), (26, 3)])
def test_geo_gcn_refuses_shapes(v, c_in):
    """V past the kernel's 32 padded rows, no node, or other than 4 inputs
    a node."""
    x, weights = _geo_args(2, v, c_in)
    with pytest.raises(ValueError, match="1 <= V <= 32"):
        geo_ops._check(x, weights)


def test_geo_gcn_accepts_its_limits():
    for v in (1, 32):
        x, weights = _geo_args(3, v)
        geo_ops._check(x, weights)


@pytest.mark.parametrize("mode", ["v1", "v4"])
def test_k5_refuses_shapes(mode):
    """More than 16 entities, or more (H + O) h' than 12288 at the width h'
    the kernel runs (h rounded up to a multiple of 4, of 8 in bfloat16); an
    h the 16-byte copies cannot take is padded, no longer refused."""
    def args(nh, no, h, dtype=torch.float32):
        t, b = 2, 2
        a = {k: torch.zeros(v.shape, dtype=dtype)
             for k, v in port_scan_tests._inputs(t, b, nh, no, h, 0).items()}
        w = (4, 2 * h) if mode == "v1" else (4, h, h)
        return a, dict(w_att=torch.zeros(w, dtype=dtype), b_att=torch.zeros(4, dtype=dtype))

    def check(nh, no, h, dtype=torch.float32):
        a, extra = args(nh, no, h, dtype)
        scan_ops._check(mode, {**a, **extra}, (2, 2, nh, no, h),
                        w_att_shape=extra["w_att"].shape,
                        io_dtypes=(torch.float32, torch.bfloat16))

    check(2, 4, 8)
    with pytest.raises(ValueError, match="H \\+ O <= 16"):
        check(8, 9, 8)
    check(2, 4, 12, torch.bfloat16)                   # run at h' = 16
    check(7, 8, 816, torch.bfloat16)                  # 15 x 816 = 12240
    with pytest.raises(ValueError, match="12288"):
        check(7, 8, 819)                              # 15 x 819 = 12285, but h' = 820
