"""K3, K4 and K5: the bidirectional gated segment scan in 'dot' attention
mode, its backward sweep, and the scan in the modes 'v1', 'v4' and 'ext'.

K3 replaces the TPU kernel ``tggcn/ops/segment_scan_pallas.py::_make_kernel``
(mode 'dot', launched by ``_seg_dir_pallas`` at ``segment_scan_pallas.py:268``).
The CUDA kernel is ``csrc/segment_scan.cu``: per time step three launches
(message projections, attention and mixing, GRU cells), both directions in
each, and no block waits for another; the products run on the tensor cores
in the 3xTF32 split (``csrc/tc_gemm.cuh``), at float32 accuracy, or in
bfloat16 on wgmma fed by TMA (``csrc/wg_gemm.cuh``). With keep
(the training forward) it keeps what the backward reads (KEPT); without
(serving), nothing per step. See the source for the bound and the design.

K4 replaces ``segment_scan_pallas.py::_make_bwd_kernel`` (launched by
``_seg_dir_bwd_pallas`` at ``segment_scan_pallas.py:546``):
``csrc/segment_scan_bwd.cu``, three launches per step, or, in bfloat16 at
h <= 512 (``bwd_plan``), two: a cluster launch that takes the message
gradients, dpre and the attention backward of one sender group, and the
carry with the next step's cell backward. Where the TPU kernel
recomputes the step from h_prev, K4 reads what K3 kept: the edge messages
(so the ReLU's derivative is the forward's), the gates and the attention;
it recomputes no gate product, score or softmax. The weight gradients are
reduced outside from its outputs and K3's kept mixed messages, as
``segment_scan_pallas.py:620-663`` does.

``segment_scan_dot_autograd`` is the differentiable entry point: a
``torch.autograd.Function`` that runs K3 forward and K4 backward (or, with
``use_kernels=False`` or on the CPU, their plain versions); when no gradient
will be taken it runs the forward alone, keeping nothing. The wrappers
refuse to run on tensors that require grad outside it. K4 adds its
per-block partial sums in a fixed order, so its gradients are the same on
every run.

K5 replaces the same TPU kernel in its other modes (``_make_kernel``
``scores_v1`` ``:123``, ``scores_v4`` ``:134``, the streamed weights of
``:147-149``): the same ``csrc/segment_scan.cu``, with the mode a template
parameter of the projection and mix phases. Each step's scores are made
once, in the projection phase, into a small float32 scratch
(``score_scratch_shape``: v1's per-entity projections, v4's partial scores
of each 32-column block), and the mix phase reads them
(``scan_occupancy`` gives each phase's blocks). It has no backward kernel, as
JAX's has none: ``segment_scan_forward`` picks the wrapper of the mode
(``segment_scan_v1``, ``segment_scan_v4``, ``segment_scan_ext``) or, with
``use_kernels=False``, the plain version ``segment_scan_att_plain``, and
``segment_scan_recompute`` (``SegmentScanRecompute``) runs such a forward
with the gradients of another function recomputed at the saved inputs, as
JAX's custom VJP for these modes recomputes through its XLA fast path
(the model passes ``models/segment_fast.py``). Its extra inputs, in the
score order hh, oh, ho, oo (receiver, then sender; w_from's order is hh,
ho, oh, oo):
  v1   w_att (4, 2h) (the receiver half, then the sender half), b_att (4)
  v4   w_att (4, h, h), b_att (4)
  ext  att_ext (T, B, E, E), E = H + O: row n < H holds [a_hh | a_oh] of
       human n, row H + o [a_ho | a_oo] of object o, already softmaxed

Layout (time-major; direction 0 runs forward in time, direction 1 backward,
both read and written in natural time order):
  gi_h (2, T, B, H, 3h), gi_o (2, T, B, O, 3h)  base input gates per cell
  u_h (T, B, H), u_o (T, B, O)                  commit decisions
  w_from (4, h, h), b_from (4, h)               message projections
                                                [h2h, h2o, o2h, o2o]
  w_msg_h, w_msg_o (2, 2h, 3h)                  message -> gate projections
  w_hh_h, w_hh_o (2, h, 3h), b_hh_h, b_hh_o (2, 3h)
  obj_mask (B, O)
  h0_h (2, B, H, h), h0_o (2, B, O, h)
  -> h_h (2, T, B, H, h), h_o (2, T, B, O, h), att_oh (2, T, B, H, O), and
     with keep the KEPT tensors

The kernels take h % 4 == 0 in float32 and h % 8 == 0 in bfloat16; at any
other h >= 1 the wrappers run them at the next such width, the padded units
zero in every operand (v1's w_att in each half, v4's on both axes), and
slice the outputs back (``segment_scan_dot_padded``,
``segment_scan_dot_bwd_padded``, ``segment_scan_att_padded``;
``ops/widths.py`` shows why the padded units stay zero and why the real
ones see exact zeros from them). The attention's scale stays the real h's.
At an aligned width nothing is copied.

K3, K4 and K5 take float32 or bfloat16 IO, all of one dtype, and pick their
variant by it; each wrapper counts the launches of its
float32 kernel in ``launches`` and of its bfloat16 kernel in
``launches_bf16``. In bfloat16 they compute what the TPU kernels compute
with ``fuse_dirs`` (``segment_scan_pallas.py:92-220``, ``:324-527``): K3
carries float32 states in a buffer of its own, not through its bfloat16
outputs; its projection and cell products take bfloat16 activations
(the states and mixed messages rounded, as ``astype(wdt)`` rounds them)
against bfloat16 weights with float32 sums; scores, softmax and mixing
take the float32 states and messages (K3's bfloat16 products, and K5's
cells and its 'ext' projections, on wgmma; K4's products
and K5's 'v1' and 'v4' projections on ``tc_gemm.cuh``). K4's
products are bfloat16 x bfloat16 with float32 sums on its bfloat16
outputs dgi, dgh and dpre, its dL/dh carry is float32, and the
mixed-message gradient and the softmax's
score gradient are rounded where the TPU kernel rounds them. Of K3's kept
tensors only the mixed messages (what the cell's product read) take the
IO dtype; the edge messages, gates and attention stay float32. K5 in
bfloat16 is K3's bfloat16 variant with each mode's scores rounded where
the TPU kernel rounds them (see ``segment_scan_att_plain``).
"""

import ctypes
from functools import partial

import torch

from tggcn_torch.nn.messages import masked_softmax
from tggcn_torch.ops import _build
from tggcn_torch.ops.widths import aligned, narrow, widen

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_ENTITIES = 16


def _cell(gi_base, msgs, h_prev, h_rec, u, w_msg, w_hh, b_hh):
    """The committed GRU cell: (h, gates), gates = [r | z | n | hn] with hn
    the recurrent n pre-activation h_rec @ w_hh_n + b_hh_n; h_rec is h_prev
    as the product reads it (rounded to the IO dtype)."""
    gi = gi_base + torch.einsum("dbnf,dfk->dbnk", msgs, w_msg)
    gh = torch.einsum("dbnh,dhk->dbnk", h_rec, w_hh) + b_hh[:, None, None]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = (1.0 - z) * n + z * h_prev
    u = u[..., None]
    return u * h_new + (1.0 - u) * h_prev, torch.cat([r, z, n, h_n], dim=-1)


def _attention(h_h, h_o, obj_mask, scores):
    """The four masked softmaxes of one step (a_hh, a_oh, a_ho, a_oo), from
    scores(recv, send, e) of the score edges e = 0 hh, 1 oh, 2 ho, 3 oo."""
    nh, no = h_h.shape[2], h_o.shape[2]
    eye_h = torch.eye(nh, dtype=h_h.dtype, device=h_h.device)
    eye_o = torch.eye(no, dtype=h_h.dtype, device=h_h.device)
    mask_obj = obj_mask[None, :, None, :]                             # (1, B, 1, O)
    return (masked_softmax(scores(h_h, h_h, 0), (1.0 - eye_h)[None, None]),
            masked_softmax(scores(h_h, h_o, 1), mask_obj),
            masked_softmax(scores(h_o, h_h, 2), torch.ones_like(eye_h[:1])),
            masked_softmax(scores(h_o, h_o, 3), mask_obj * (1.0 - eye_o)[None, None]))


def _dot_scores(scale):
    return lambda recv, send, e: torch.einsum("dbnh,dbmh->dbnm", recv, send) * scale


# What K3 keeps for the backward (K4) when asked to (keep=True), each
# (2, T, B, E_group, width) but atts (2, T, B, E, E):
#   m_h, m_o       the edge messages each step read, [h2h | h2o] and [o2h | o2o]
#   gates_h, gates_o   the gates [r | z | n | hn] of every cell row (4h)
#   mix_h, mix_o   the attention-mixed messages (2h), in the IO dtype
#   atts           the softmaxed attention: row n < H holds [a_hh | a_oh] of
#                  human n, row H + o [a_ho | a_oo] of object o
# All float32 but mix_h and mix_o.
KEPT = ("m_h", "m_o", "gates_h", "gates_o", "mix_h", "mix_o", "atts")


def _scan_plain(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
                b_hh_h, b_hh_o, h0_h, h0_o, attention, keep, round_carry=False):
    """The plain scan: a Python loop over time, both directions batched on
    the leading axis; attention(h_h, h_o, ts) gives the step's four weights
    from the carried states and the times ts each direction processes.
    Returns (h_h, h_o, att_oh), followed with keep by the KEPT tensors.
    It computes in float32 with float32 states whatever the IO dtype, and
    rounds to it where the kernel does: the products' activations (states
    and mixed messages) and the outputs. round_carry also rounds the
    carried states to it after every step, as JAX's XLA route does and the
    kernels do not: a control for the checks that hold K3 to this version."""
    io = gi_h.dtype
    q = _build.rounding(io)
    carry = q if round_carry else (lambda x: x)
    (gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, b_hh_h, b_hh_o,
     h0_h, h0_o) = (_build.upcast(x) for x in (gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o,
                                        w_hh_h, w_hh_o, b_hh_h, b_hh_o, h0_h, h0_o))
    t, b, nh, no = gi_h.shape[1], gi_h.shape[2], gi_h.shape[3], gi_o.shape[3]
    h = w_hh_h.shape[1]
    out_h = gi_h.new_empty(gi_h.shape[:-1] + (h,))
    out_o = gi_o.new_empty(gi_o.shape[:-1] + (h,))
    att = gi_h.new_empty(gi_h.shape[:-1] + (no,))
    if keep:
        kept = dict(m_h=gi_h.new_empty(gi_h.shape[:-1] + (2 * h,)),
                    m_o=gi_o.new_empty(gi_o.shape[:-1] + (2 * h,)),
                    gates_h=gi_h.new_empty(gi_h.shape[:-1] + (4 * h,)),
                    gates_o=gi_o.new_empty(gi_o.shape[:-1] + (4 * h,)),
                    mix_h=gi_h.new_empty(gi_h.shape[:-1] + (2 * h,), dtype=io),
                    mix_o=gi_o.new_empty(gi_o.shape[:-1] + (2 * h,), dtype=io),
                    atts=gi_h.new_empty((2, t, b, nh + no, nh + no)))
    h_h, h_o = h0_h, h0_o

    def proj(x, e):
        return torch.relu(torch.matmul(q(x), w_from[e]) + b_from[e])

    for i in range(t):
        ts = (i, t - 1 - i)                                           # per direction
        m_hh, m_ho, m_oh, m_oo = proj(h_h, 0), proj(h_h, 1), proj(h_o, 2), proj(h_o, 3)
        a_hh, a_oh, a_ho, a_oo = attention(h_h, h_o, ts)
        msgs_h = q(torch.cat([a_hh @ m_hh, a_oh @ m_oh], dim=-1))     # (2, B, H, 2h)
        msgs_o = q(torch.cat([a_ho @ m_ho, a_oo @ m_oo], dim=-1))     # (2, B, O, 2h)
        gib_h = torch.stack([gi_h[d, ts[d]] for d in range(2)])
        gib_o = torch.stack([gi_o[d, ts[d]] for d in range(2)])
        uh = torch.stack([u_h[ts[d]] for d in range(2)])
        uo = torch.stack([u_o[ts[d]] for d in range(2)])
        h_h, gates_h = _cell(gib_h, msgs_h, h_h, q(h_h), uh, w_msg_h, w_hh_h, b_hh_h)
        h_o, gates_o = _cell(gib_o, msgs_o, h_o, q(h_o), uo, w_msg_o, w_hh_o, b_hh_o)
        h_h, h_o = carry(h_h), carry(h_o)
        for d in range(2):
            out_h[d, ts[d]], out_o[d, ts[d]], att[d, ts[d]] = h_h[d], h_o[d], a_oh[d]
        if keep:
            step = dict(m_h=torch.cat([m_hh, m_ho], dim=-1), m_o=torch.cat([m_oh, m_oo], dim=-1),
                        gates_h=gates_h, gates_o=gates_o, mix_h=msgs_h, mix_o=msgs_o,
                        atts=torch.cat([torch.cat([a_hh, a_oh], dim=-1),
                                        torch.cat([a_ho, a_oo], dim=-1)], dim=-2))
            for k, v in step.items():
                for d in range(2):
                    kept[k][d, ts[d]] = v[d]
    return ((out_h.to(io), out_o.to(io), att.to(io))
            + (tuple(kept[k] for k in KEPT) if keep else ()))


def segment_scan_dot_plain(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o,
                           w_hh_h, w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o,
                           scale: float, keep: bool = True, round_carry: bool = False):
    """Plain PyTorch version of K3: (h_h, h_o, att_oh), followed with keep
    by the KEPT tensors; round_carry as _scan_plain's."""
    scores = _dot_scores(scale)
    return _scan_plain(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h,
                       w_hh_o, b_hh_h, b_hh_o, h0_h, h0_o,
                       lambda h_h, h_o, ts: _attention(h_h, h_o, obj_mask, scores), keep,
                       round_carry)


MODES = ("v1", "v4", "ext")


def _v1_scores(q, w_att, b_att):
    """K5's concat scores relu(q(recv) . wa[:h] + q(send) . wa[h:] + b), q
    the rounding to the IO dtype."""
    h = w_att.shape[1] // 2

    def scores(recv, send, e):
        qr, ks = q(recv) @ w_att[e, :h], q(send) @ w_att[e, h:]      # (2, B, R), (2, B, S)
        return torch.relu(qr[..., :, None] + ks[..., None, :] + b_att[e])
    return scores


def _v4_scores(q, w_att, b_att):
    """K5's bilinear scores relu(q(q(recv) @ W) @ send^T + b): the product
    recv @ W takes the rounded state and is itself rounded, the second
    takes the unrounded sender state (bfloat16 x float32 promotes to
    float32, ``segment_scan_pallas.py:139-142``)."""
    def scores(recv, send, e):
        return torch.relu(q(q(recv) @ w_att[e]) @ send.transpose(-1, -2) + b_att[e])
    return scores


def segment_scan_att_plain(mode, gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o,
                           w_hh_h, w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o,
                           w_att=None, b_att=None, att_ext=None, round_carry: bool = False):
    """Plain PyTorch version of K5 in `mode`: (h_h, h_o, att_oh). In
    bfloat16 it rounds where the TPU kernel rounds (``scores_v1`` ``:123``,
    ``scores_v4`` ``:134``, ``:147-149``), from the float32 states: v1 takes
    the states rounded to bfloat16 against the bfloat16 weights; v4 rounds
    the state for recv @ W and that product's float32 sum, then multiplies it
    by the float32 sender state at float32 accuracy; ext widens the weights
    computed outside. round_carry as _scan_plain's."""
    if mode not in MODES:
        raise ValueError(f"segment scan mode {mode!r} is not one of {MODES}")
    nh = gi_h.shape[3]
    q = _build.rounding(gi_h.dtype)
    if mode == "ext":
        att_ext = _build.upcast(att_ext)

        def attention(h_h, h_o, ts):
            a = torch.stack([att_ext[ts[d]] for d in range(2)])       # (2, B, E, E)
            return a[..., :nh, :nh], a[..., :nh, nh:], a[..., nh:, :nh], a[..., nh:, nh:]
    else:
        w_att, b_att = _build.upcast(w_att), _build.upcast(b_att)
        scores = (_v1_scores if mode == "v1" else _v4_scores)(q, w_att, b_att)

        def attention(h_h, h_o, ts):
            return _attention(h_h, h_o, obj_mask, scores)
    return _scan_plain(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h,
                       w_hh_o, b_hh_h, b_hh_o, h0_h, h0_o, attention, keep=False,
                       round_carry=round_carry)


# K3's kept tensors and K4's inputs that are float32 whatever the IO dtype.
FLOAT32 = ("m_h", "m_o", "gates_h", "gates_o", "atts")


def _check(what, args, dims, w_att_shape=None, io_dtypes=(torch.float32,)):
    """Device, dtype, shape and contiguity of every tensor in args, and the
    kernels' limits; dims = (T, B, H, O, h). The tensors of FLOAT32 are
    float32, the others all of one IO dtype of io_dtypes, which is
    returned. Any h >= 1: the launch runs at h' = aligned(h), whose
    (H + O) * h' must stay within 12288 (the float32 states of a batch
    row's entities in 48 KB of shared memory)."""
    t, b, nh, no, h = dims
    e = nh + no
    shapes = {
        "gi_h": (2, t, b, nh, 3 * h), "gi_o": (2, t, b, no, 3 * h),
        "u_h": (t, b, nh), "u_o": (t, b, no),
        "w_from": (4, h, h), "b_from": (4, h),
        "w_msg_h": (2, 2 * h, 3 * h), "w_msg_o": (2, 2 * h, 3 * h),
        "w_hh_h": (2, h, 3 * h), "w_hh_o": (2, h, 3 * h),
        "b_hh_h": (2, 3 * h), "b_hh_o": (2, 3 * h), "obj_mask": (b, no),
        "h0_h": (2, b, nh, h), "h0_o": (2, b, no, h),
        "hprev_h": (2, t, b, nh, h), "hprev_o": (2, t, b, no, h),
        "m_h": (2, t, b, nh, 2 * h), "m_o": (2, t, b, no, 2 * h),
        "gates_h": (2, t, b, nh, 4 * h), "gates_o": (2, t, b, no, 4 * h),
        "atts": (2, t, b, e, e),
        "g_h": (2, t, b, nh, h), "g_o": (2, t, b, no, h), "g_att": (2, t, b, nh, no),
        "w_att": w_att_shape, "b_att": (4,), "att_ext": (t, b, e, e),
    }
    first = next(iter(args.values()))
    device, io = first.device, first.dtype
    if io not in io_dtypes:
        raise ValueError(f"{what}: the IO dtype {io} is not one of {io_dtypes}")
    for name, x in args.items():
        want = torch.float32 if name in FLOAT32 else io
        if x.device != device or x.dtype != want:
            raise ValueError(f"{what}: {name} must be {want} on {device} "
                             f"(the IO dtype is {next(iter(args))}'s)")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, want {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if h < 1 or nh < 1 or no < 1 or e > MAX_ENTITIES or e * aligned(h, io) * 4 > 48 * 1024:
        raise ValueError(f"{what}: needs h >= 1, 1 <= H, O, H + O <= {MAX_ENTITIES} and "
                         "(H + O) * h' <= 12288, h' being h rounded up to a multiple of 4 "
                         "(of 8 in bfloat16)")
    return io


def _dims(gi_h, gi_o):
    _, t, b, nh, g3 = gi_h.shape
    if g3 % 3:
        raise ValueError(f"gi_h's last dimension {g3} is not 3h")
    return t, b, nh, gi_o.shape[3], g3 // 3


def scan_buffers(t, b, nh, no, h, keep, device, io=torch.float32):
    """What K3 (and K5, without keep) writes: its outputs (h_h, h_o,
    att_oh) in the IO dtype; with keep the KEPT tensors, every step's;
    without, one step's edge and mixed messages per direction, the kernel's
    scratch (serving keeps nothing per step). The mixed messages take the
    IO dtype, the rest float32."""
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, device=device, dtype=dtype)
    out = [empty(2, t, b, nh, h, dtype=io), empty(2, t, b, no, h, dtype=io),
           empty(2, t, b, nh, no, dtype=io)]
    if keep:
        kept = dict(m_h=empty(2, t, b, nh, 2 * h), m_o=empty(2, t, b, no, 2 * h),
                    gates_h=empty(2, t, b, nh, 4 * h), gates_o=empty(2, t, b, no, 4 * h),
                    mix_h=empty(2, t, b, nh, 2 * h, dtype=io),
                    mix_o=empty(2, t, b, no, 2 * h, dtype=io),
                    atts=empty(2, t, b, nh + no, nh + no))
    else:
        kept = dict(m_h=empty(2, b, nh, 2 * h), m_o=empty(2, b, no, 2 * h),
                    mix_h=empty(2, b, nh, 2 * h, dtype=io), mix_o=empty(2, b, no, 2 * h, dtype=io))
    return out, kept


# The scan's inputs in the order of its wrappers' and plain versions'
# arguments, the names of its outputs, and of K4's inputs.
SCAN_INPUTS = ("gi_h", "gi_o", "u_h", "u_o", "w_from", "b_from", "w_msg_h", "w_msg_o",
               "w_hh_h", "w_hh_o", "b_hh_h", "b_hh_o", "obj_mask", "h0_h", "h0_o")
SCAN_OUTPUTS = ("h_h", "h_o", "att_oh")
BWD_INPUTS = ("u_h", "u_o", "hprev_h", "hprev_o", "m_h", "m_o", "gates_h", "gates_o", "atts",
              "g_h", "g_o", "g_att", "w_from", "w_msg_h", "w_msg_o", "w_hh_h", "w_hh_o")
# The h-wide axes of each tensor of K3-K5 that has any, as (axis, blocks):
# the gates [r | z | n] (3), [r | z | n | hn] (4), the message halves (2).
# The others (decisions, masks, attention, du) have none.
_H_AXES = {
    "gi_h": ((-1, 3),), "gi_o": ((-1, 3),), "w_from": ((-1, 1), (-2, 1)), "b_from": ((-1, 1),),
    "w_msg_h": ((-1, 3), (-2, 2)), "w_msg_o": ((-1, 3), (-2, 2)),
    "w_hh_h": ((-1, 3), (-2, 1)), "w_hh_o": ((-1, 3), (-2, 1)),
    "b_hh_h": ((-1, 3),), "b_hh_o": ((-1, 3),), "h0_h": ((-1, 1),), "h0_o": ((-1, 1),),
    "h_h": ((-1, 1),), "h_o": ((-1, 1),), "hprev_h": ((-1, 1),), "hprev_o": ((-1, 1),),
    "g_h": ((-1, 1),), "g_o": ((-1, 1),), "m_h": ((-1, 2),), "m_o": ((-1, 2),),
    "gates_h": ((-1, 4),), "gates_o": ((-1, 4),), "mix_h": ((-1, 2),), "mix_o": ((-1, 2),),
    "dgi_h": ((-1, 3),), "dgi_o": ((-1, 3),), "dgh_h": ((-1, 3),), "dgh_o": ((-1, 3),),
    "dpre_h": ((-1, 2),), "dpre_o": ((-1, 2),), "dh0_h": ((-1, 1),), "dh0_o": ((-1, 1),),
    "w_att_v1": ((-1, 2),), "w_att_v4": ((-1, 1), (-2, 1)),
}


def _resize(named, h, hp, fn, rename=None):
    """{name: fn(tensor) along each of the name's h axes} (fn widen or
    narrow); rename maps a name to the one _H_AXES knows it by."""
    out = {}
    for k, x in named.items():
        axes = _H_AXES.get((rename or {}).get(k, k))
        out[k] = fn(x, h, hp, axes) if axes and x is not None else x
    return out


def segment_scan_dot_padded(run, *args, scale: float, keep: bool = True, width=None):
    """run (K3's launch or its plain version) on args (SCAN_INPUTS) at the
    width h' (default aligned(h) in the IO dtype), its outputs (and with
    keep the KEPT tensors) narrowed back to h: every operand widened with
    zero units, which stay zero (``ops/widths.py``); scale stays the
    caller's. At h' == h it is run itself, on the caller's tensors."""
    named = dict(zip(SCAN_INPUTS, args))
    h = named["h0_h"].shape[-1]
    hp = width or aligned(h, named["gi_h"].dtype)
    if hp == h:
        return run(*args, scale=scale, keep=keep)
    out = run(*_resize(named, h, hp, widen).values(), scale=scale, keep=keep)
    names = SCAN_OUTPUTS + (KEPT if keep else ())
    return tuple(_resize(dict(zip(names, out)), h, hp, narrow).values())


def segment_scan_dot(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o,
                     w_hh_h, w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o,
                     scale: float, keep: bool = True):
    """(h_h, h_o, att_oh) of both directions, followed with keep by the
    KEPT tensors; CPU tensors take the plain version, CUDA tensors the
    kernel, at any h (segment_scan_dot_padded)."""
    args = dict(gi_h=gi_h, gi_o=gi_o, u_h=u_h, u_o=u_o, w_from=w_from,
                b_from=b_from, w_msg_h=w_msg_h, w_msg_o=w_msg_o, w_hh_h=w_hh_h,
                w_hh_o=w_hh_o, b_hh_h=b_hh_h, b_hh_o=b_hh_o, obj_mask=obj_mask,
                h0_h=h0_h, h0_o=h0_o)
    _build.refuse_autograd("segment_scan_dot", *args.values())
    if gi_h.device.type == "cpu":
        return segment_scan_dot_plain(**args, scale=scale, keep=keep)
    if gi_h.device.type != "cuda":
        raise ValueError(f"segment_scan_dot runs on CUDA or the CPU, not {gi_h.device}")
    _check("segment_scan_dot", args, _dims(gi_h, gi_o),
           io_dtypes=(torch.float32, torch.bfloat16))
    return segment_scan_dot_padded(_launch_segment_scan_dot, *args.values(), scale=scale,
                                   keep=keep)


def _launch_segment_scan_dot(*args, scale, keep):
    """K3 on checked tensors (SCAN_INPUTS) at an aligned width."""
    gi_h, h0_h, h0_o = args[0], args[-2], args[-1]
    dims = _dims(gi_h, args[1])
    io = gi_h.dtype
    t = dims[0]
    out, kept = scan_buffers(*dims, keep, gi_h.device, io)
    if t > 0:
        lib = _build.load_library("segment_scan")
        ptrs = [x.data_ptr() for x in (*args, *out)]
        ptrs += [kept[k].data_ptr() if k in kept else None
                 for k in ("m_h", "m_o", "mix_h", "mix_o", "gates_h", "gates_o", "atts")]
        if io == torch.float32:
            fn = lib.tggcn_segment_scan_dot_f32
        else:
            # The float32 states (2, B * E, h), updated in place each step.
            fn = lib.tggcn_segment_scan_dot_bf16
            states = [h0_h.float().contiguous(), h0_o.float().contiguous()]
            ptrs += [x.data_ptr() for x in states]
        fn.argtypes = [_P] * len(ptrs) + [_I] * 6 + [ctypes.c_float, _P]
        fn.restype = _I
        with torch.cuda.device(gi_h.device):
            stream = torch.cuda.current_stream(gi_h.device).cuda_stream
            err = fn(*ptrs, int(keep), *dims, float(scale), stream)
        _build.check_launch(err, "segment_scan_dot")
        _build.count_launch(segment_scan_dot, io)
    return tuple(out) + (tuple(kept[k] for k in KEPT) if keep else ())


segment_scan_dot.launches = segment_scan_dot.launches_bf16 = 0


# Columns of a v4 partial score: the 32 columns of each projection block
# (csrc/segment_scan.cu, proj_v4_kernel).
V4_PART_COLUMNS = 32


def score_scratch_shape(mode, b, nh, no, h):
    """The shape of K5's score scratch in `mode` (float32), which its
    projection phase writes and its mix phase reads, or None: v1 the four
    projections of each entity's state (2, B, E, 4); v4 the partial
    bilinear scores of each 32-column block, summed in column order by the
    mix phase (2, B, E, E, ceil(h / 32)); ext none."""
    e = nh + no
    if mode == "v1":
        return (2, b, e, 4)
    if mode == "v4":
        return (2, b, e, e, -(-h // V4_PART_COLUMNS))
    return None


PHASES = ("proj", "mix", "cell")


def scan_occupancy(mode, dtype, b, nh, no, h):
    """The launch shapes of K3 ('dot') or K5 in `mode` at (B, H, O, h) on
    the current CUDA device: {phase: (blocks, blocks an SM holds at once,
    dynamic shared memory bytes)} for the phases A (proj), M (mix) and B
    (cell), from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    fn = _build.load_library("segment_scan").tggcn_segment_scan_occupancy
    fn.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = (ctypes.c_int * 9)()
    code = ("dot",) + MODES
    _build.check_launch(fn(code.index(mode), int(dtype == torch.bfloat16), b, nh, no, h, out),
                        "segment_scan occupancy")
    return {p: (out[i], out[3 + i], out[6 + i]) for i, p in enumerate(PHASES)}


def segment_scan_att_padded(run, mode, *args, width=None, **extra):
    """run (K5's launch or its plain version, run(mode, *args, **extra)) on
    args (SCAN_INPUTS) at the width h', as segment_scan_dot_padded; v1's
    w_att is widened in each of its halves, v4's on both axes; att_ext has
    no h axis."""
    named = dict(zip(SCAN_INPUTS, args))
    h = named["h0_h"].shape[-1]
    hp = width or aligned(h, named["gi_h"].dtype)
    if hp == h:
        return run(mode, *args, **extra)
    extra = _resize(extra, h, hp, widen, rename={"w_att": f"w_att_{mode}"})
    out = run(mode, *_resize(named, h, hp, widen).values(), **extra)
    return tuple(_resize(dict(zip(SCAN_OUTPUTS, out)), h, hp, narrow).values())


def _segment_scan_att(wrapper, mode, args, extra):
    """K5 in `mode` for the tensors of args (K3's inputs) and extra (the
    mode's); CPU tensors take the plain version, CUDA tensors the kernel at
    any h (segment_scan_att_padded). Counts its launch on `wrapper`."""
    _build.refuse_autograd(f"segment_scan_{mode}", *args.values(), *extra.values())
    gi_h = args["gi_h"]
    if gi_h.device.type == "cpu":
        return segment_scan_att_plain(mode, **args, **extra)
    if gi_h.device.type != "cuda":
        raise ValueError(f"segment_scan_{mode} runs on CUDA or the CPU, not {gi_h.device}")
    dims = _dims(gi_h, args["gi_o"])
    h = dims[-1]
    _check(f"segment_scan_{mode}", {**args, **extra}, dims,
           w_att_shape=(4, 2 * h) if mode == "v1" else (4, h, h),
           io_dtypes=(torch.float32, torch.bfloat16))
    return segment_scan_att_padded(partial(_launch_segment_scan_att, wrapper), mode,
                                   *args.values(), **extra)


def _launch_segment_scan_att(wrapper, mode, *args, **extra):
    """K5 in `mode` on checked tensors (args in SCAN_INPUTS' order) at an
    aligned width."""
    gi_h, h0_h, h0_o = args[0], args[-2], args[-1]
    dims = _dims(gi_h, args[1])
    t, b, nh, no, h = dims
    io, dev = gi_h.dtype, gi_h.device
    out, scratch = scan_buffers(*dims, False, dev, io)
    if t > 0:
        shape = score_scratch_shape(mode, b, nh, no, h)
        scores = torch.empty(shape, device=dev) if shape else None
        ptrs = [x.data_ptr() for x in args]
        ptrs += [extra[k].data_ptr() if k in extra else None
                 for k in ("w_att", "b_att", "att_ext")]
        ptrs += [x.data_ptr() if x is not None else None
                 for x in (*out, scratch["m_h"], scratch["m_o"], scores, scratch["mix_h"],
                           scratch["mix_o"])]
        lib = _build.load_library("segment_scan")
        if io == torch.float32:
            fn = lib.tggcn_segment_scan_att_f32
        else:
            # The float32 states (2, B * E, h), updated in place each step.
            fn = lib.tggcn_segment_scan_att_bf16
            states = [h0_h.float().contiguous(), h0_o.float().contiguous()]
            ptrs += [x.data_ptr() for x in states]
        fn.argtypes = [_I] + [_P] * len(ptrs) + [_I] * 5 + [_P]
        fn.restype = _I
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(1 + MODES.index(mode), *ptrs, t, b, nh, no, h, stream)
        _build.check_launch(err, f"segment_scan_{mode}")
        _build.count_launch(wrapper, io)
    return tuple(out)


def segment_scan_v1(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
                    b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att):
    """K5 in mode 'v1' (concat-MLP scores): (h_h, h_o, att_oh)."""
    args = {k: v for k, v in locals().items() if k not in ("w_att", "b_att")}
    return _segment_scan_att(segment_scan_v1, "v1", args, dict(w_att=w_att, b_att=b_att))


def segment_scan_v4(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
                    b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, w_att, b_att):
    """K5 in mode 'v4' (bilinear scores): (h_h, h_o, att_oh)."""
    args = {k: v for k, v in locals().items() if k not in ("w_att", "b_att")}
    return _segment_scan_att(segment_scan_v4, "v4", args, dict(w_att=w_att, b_att=b_att))


def segment_scan_ext(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
                     b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, att_ext):
    """K5 in mode 'ext' (weights computed outside): (h_h, h_o, att_oh)."""
    args = {k: v for k, v in locals().items() if k != "att_ext"}
    return _segment_scan_att(segment_scan_ext, "ext", args, dict(att_ext=att_ext))


for _wrapper in (segment_scan_v1, segment_scan_v4, segment_scan_ext):
    _wrapper.launches = _wrapper.launches_bf16 = 0


def segment_scan_forward(mode, *args, use_kernels: bool = True, **extra):
    """The forward-only scan of a K5 mode: its wrapper, or with
    use_kernels=False its plain version on any device (the reference)."""
    if not use_kernels:
        return segment_scan_att_plain(mode, *args, **extra)
    wrapper = {"v1": segment_scan_v1, "v4": segment_scan_v4, "ext": segment_scan_ext}[mode]
    return wrapper(*args, **extra)


RECOMPUTE_RANGE = "segment_scan_recompute_backward"


class SegmentScanRecompute(torch.autograd.Function):
    """A forward that runs without autograd (K5), and a backward that takes
    autograd of another function of the same inputs, recomputed at the
    saved inputs: the counterpart of ``segment_scan_fast_pallas``'s custom
    VJP (``segment_scan_pallas.py:911-942``), whose backward recomputes
    through the XLA fast path. run(*inputs) and recompute(*inputs) return
    the same tuple of tensors; inputs may hold None."""

    @staticmethod
    def forward(ctx, run, recompute, *inputs):
        ctx.recompute = recompute
        ctx.save_for_backward(*inputs)
        return run(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        inputs = [x.detach().requires_grad_(need) if x is not None else None
                  for x, need in zip(ctx.saved_tensors, needs)]
        wanted = [x for x, need in zip(inputs, needs) if need]
        # The range names the recompute in a profiler's trace (profile_step).
        with torch.enable_grad(), torch.profiler.record_function(RECOMPUTE_RANGE):
            outs = ctx.recompute(*inputs)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            found = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                             [g for _, g in pairs], allow_unused=True)
                         if pairs and wanted else ())
        return (None, None, *(next(found, None) if need else None for need in needs))


def segment_scan_recompute(run, recompute, *inputs):
    """run(*inputs) (K5's route, without autograd) with the gradients of
    recompute(*inputs) (the XLA fast path's counterpart); see
    SegmentScanRecompute. When no gradient will be taken (grad disabled, or
    no input requires one) it is run(*inputs) alone."""
    if not (torch.is_grad_enabled()
            and any(x is not None and x.requires_grad for x in inputs)):
        return run(*inputs)
    return SegmentScanRecompute.apply(run, recompute, *inputs)


def previous_states(out, h0):
    """The state each step read (2, T, ...), in natural time order:
    direction 0 read the step before, direction 1 the step after."""
    return torch.stack([torch.cat([h0[0, None], out[0, :-1]]),
                        torch.cat([out[1, 1:], h0[1, None]])]).contiguous()


BWD_OUTPUTS = ("dgi_h", "dgi_o", "dgh_h", "dgh_o", "dpre_h", "dpre_o", "du_h", "du_o",
               "dh0_h", "dh0_o")


def segment_scan_dot_bwd_plain(u_h, u_o, hprev_h, hprev_o, m_h, m_o, gates_h, gates_o, atts,
                               g_h, g_o, g_att, w_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
                               scale: float, round_carry: bool = False):
    """Plain PyTorch version of K4: a Python loop that visits time opposite
    to the forward, both directions batched on the leading axis, from the
    states (hprev) each forward step read and what K3 kept of it (the edge
    messages m, the gates and the attention atts; see KEPT): nothing is
    recomputed. Returns a dict of BWD_OUTPUTS: per step dgi, dgh (2, T, B, E,
    3h), the message pre-ReLU gradients dpre (2, T, B, E, 2h; dpre_h holds
    the edges hh | ho, dpre_o oh | oo), du (2, T, B, E) per direction, and
    dh0 (2, B, E, h). It computes in float32 whatever the IO dtype and
    rounds to it where the kernel does: the products' operands dgi, dgh and
    dpre, the mixed-message gradient dmsgs, the score gradient ds, and the
    outputs. round_carry also rounds the carried dL/dh to it after every
    step: a control, as K3's."""
    io = hprev_h.dtype
    q = _build.rounding(io)
    carry = q if round_carry else (lambda x: x)
    (u_h, u_o, hprev_h, hprev_o, g_h, g_o, g_att, w_from, w_msg_h, w_msg_o, w_hh_h,
     w_hh_o) = (_build.upcast(x) for x in (u_h, u_o, hprev_h, hprev_o, g_h, g_o, g_att, w_from,
                                    w_msg_h, w_msg_o, w_hh_h, w_hh_o))
    h = w_hh_h.shape[1]
    t, nh = hprev_h.shape[1], hprev_h.shape[3]
    new = lambda like, width: like.new_empty(like.shape[:-1] + (width,))
    out = dict(dgi_h=new(hprev_h, 3 * h), dgi_o=new(hprev_o, 3 * h),
               dgh_h=new(hprev_h, 3 * h), dgh_o=new(hprev_o, 3 * h),
               dpre_h=new(hprev_h, 2 * h), dpre_o=new(hprev_o, 2 * h),
               du_h=hprev_h.new_empty(hprev_h.shape[:-1]),
               du_o=hprev_o.new_empty(hprev_o.shape[:-1]))
    dh_h, dh_o = hprev_h.new_zeros(hprev_h[:, 0].shape), hprev_o.new_zeros(hprev_o[:, 0].shape)

    # q rounds where the TPU kernel computes in the IO dtype (the gates and
    # the elementwise cell backward, segment_scan_pallas.py:409-459; the
    # attention and messages it recomputes, :362-393); the identity in
    # float32.
    def cell_bwd(gates, hp, u, dH, w_msg, w_hh):
        r, z, n, hn = (q(x) for x in gates.chunk(4, dim=-1))
        omz = q(1.0 - z)
        h_new = q(omz * n) + z * hp
        du = torch.sum(dH * (h_new - hp), dim=-1)
        dh_new = q(dH * u[..., None])
        dtanh = q(q(dh_new * omz) * q(1.0 - q(n * n)))
        d_ir = q(q(q(dtanh * hn) * r) * q(1.0 - r))
        d_iz = q(q(q(dh_new * q(hp - n)) * z) * omz)
        dgi = torch.cat([d_ir, d_iz, dtanh], dim=-1)
        dgh = torch.cat([d_ir, d_iz, q(dtanh * r)], dim=-1)
        dhp = (dH * (1.0 - u[..., None]) + q(dh_new * z)
               + torch.einsum("dbnk,dhk->dbnh", dgh, w_hh))
        return dgi, dgh, du, dhp, q(torch.einsum("dbnk,dfk->dbnf", dgi, w_msg))

    def att_bwd(a, m, dmg, recv, send, e, extra=None):
        a = q(a)
        da = torch.einsum("dbrh,dbsh->dbrs", dmg, q(m))
        if extra is not None:
            da = da + extra
        dm = torch.einsum("dbrs,dbrh->dbsh", a, dmg)
        ds = q(a * (da - torch.sum(da * a, dim=-1, keepdim=True)))
        dpre = q(dm * (m > 0).to(dm.dtype))
        dsend = scale * torch.einsum("dbrs,dbrh->dbsh", ds, recv)
        dsend = dsend + torch.matmul(dpre, w_from[e].transpose(0, 1))
        return scale * torch.einsum("dbrs,dbsh->dbrh", ds, send), dsend, dpre

    for i in range(t):
        ts = (t - 1 - i, i)                                           # per direction

        def at(x):
            return torch.stack([x[d, ts[d]] for d in range(2)])

        hh, ho = at(hprev_h), at(hprev_o)
        (m_hh, m_ho), (m_oh, m_oo) = at(m_h).chunk(2, dim=-1), at(m_o).chunk(2, dim=-1)
        groups = [nh, atts.shape[-1] - nh]
        (a_hh, a_oh), (a_ho, a_oo) = (r.split(groups, dim=-1) for r in at(atts).split(groups, -2))
        uh = torch.stack([u_h[ts[d]] for d in range(2)])
        uo = torch.stack([u_o[ts[d]] for d in range(2)])
        dgi_h, dgh_h, du_h, dhp_h, dmsgs_h = cell_bwd(
            at(gates_h), hh, uh, dh_h + at(g_h), w_msg_h, w_hh_h)
        dgi_o, dgh_o, du_o, dhp_o, dmsgs_o = cell_bwd(
            at(gates_o), ho, uo, dh_o + at(g_o), w_msg_o, w_hh_o)
        dr_hh, ds_hh, dp_hh = att_bwd(a_hh, m_hh, dmsgs_h[..., :h], hh, hh, 0)
        dr_oh, ds_oh, dp_oh = att_bwd(a_oh, m_oh, dmsgs_h[..., h:], hh, ho, 2, at(g_att))
        dr_ho, ds_ho, dp_ho = att_bwd(a_ho, m_ho, dmsgs_o[..., :h], ho, hh, 1)
        dr_oo, ds_oo, dp_oo = att_bwd(a_oo, m_oo, dmsgs_o[..., h:], ho, ho, 3)
        dh_h = carry(dhp_h + dr_hh + ds_hh + dr_oh + ds_ho)
        dh_o = carry(dhp_o + ds_oh + dr_ho + dr_oo + ds_oo)
        step = dict(dgi_h=dgi_h, dgi_o=dgi_o, dgh_h=dgh_h, dgh_o=dgh_o,
                    dpre_h=torch.cat([dp_hh, dp_ho], dim=-1),
                    dpre_o=torch.cat([dp_oh, dp_oo], dim=-1), du_h=du_h, du_o=du_o)
        for k, v in step.items():
            for d in range(2):
                out[k][d, ts[d]] = v[d]
    out.update(dh0_h=dh_h, dh0_o=dh_o)
    return {k: v.to(io) for k, v in out.items()}


def segment_scan_dot_weight_grads(hprev_h, hprev_o, mix_h, mix_o, grads):
    """The weight and bias gradients, reduced outside the kernel as large
    products over its per-step outputs and K3's kept mixed messages (as
    ``segment_scan_pallas.py:620-663`` does), in the IO dtype, whose
    products sum in float32 (runtime.py pins cuBLAS so for bfloat16; the
    TPU kernel's route sums them in float32 and casts the result to the
    weights' bfloat16): (dw_from, db_from, dw_msg_h, dw_msg_o, dw_hh_h,
    dw_hh_o, db_hh_h, db_hh_o)."""
    h = hprev_h.shape[-1]

    def red(a, b):                                   # per direction (2, F, G)
        return torch.einsum("dtbeh,dtbeg->dhg", a, b)

    def both(a, b):                                  # summed over the directions
        return torch.einsum("dtbeh,dtbeg->hg", a, b)

    dpre_h, dpre_o = grads["dpre_h"], grads["dpre_o"]
    parts = [(hprev_h, dpre_h[..., :h]), (hprev_h, dpre_h[..., h:]),
             (hprev_o, dpre_o[..., :h]), (hprev_o, dpre_o[..., h:])]
    return (torch.stack([both(x, dp) for x, dp in parts]),
            torch.stack([dp.sum(dim=(0, 1, 2, 3)) for _, dp in parts]),
            red(mix_h, grads["dgi_h"]), red(mix_o, grads["dgi_o"]),
            red(hprev_h, grads["dgh_h"]), red(hprev_o, grads["dgh_o"]),
            grads["dgh_h"].sum(dim=(1, 2, 3)), grads["dgh_o"].sum(dim=(1, 2, 3)))


# The bfloat16 backward's plan (csrc/segment_scan_bwd.cu, cluster_plan):
# route 1 for the two-launch route (else 0, the per-step route); DA's
# blocks a cluster, clusters a step and dynamic shared memory; R's blocks a
# step and dynamic shared memory; the batch tile of a DA cluster; and the
# most DA clusters the card holds at once (-1 unless asked for and on the
# two-launch route).
BWD_PLAN_KEYS = ("route", "da_blocks", "da_clusters", "da_smem", "r_blocks", "r_smem",
                 "batch_tile", "da_co_resident")
BWD_ROUTES = ("cluster", "steps")


def bwd_plan(b, nh, no, h, occupancy: bool = True):
    """The plan of K4's bfloat16 kernel at (B, H, O, h), as its source makes
    it (BWD_PLAN_KEYS); with occupancy, the clusters the current CUDA device
    holds at once. Builds the library if needed."""
    fn = _build.load_library("segment_scan_bwd").tggcn_segment_scan_dot_bwd_plan
    fn.argtypes = [_I] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = (ctypes.c_int * len(BWD_PLAN_KEYS))()
    _build.check_launch(fn(b, nh, no, h, int(occupancy), out), "segment_scan_dot_bwd plan")
    return dict(zip(BWD_PLAN_KEYS, out))


def segment_scan_dot_bwd_padded(run, *args, scale: float, width=None, **kw):
    """run (K4's launch or its plain version) on args (BWD_INPUTS) at the
    width h', as segment_scan_dot_padded: the cotangents' padded units are
    zero, so is their carry, and their dgi, dgh, dpre and dh0 are sliced
    away (du has no h axis). kw goes to run (the launch's route)."""
    named = dict(zip(BWD_INPUTS, args))
    h = named["hprev_h"].shape[-1]
    hp = width or aligned(h, named["hprev_h"].dtype)
    if hp == h:
        return run(*args, scale=scale, **kw)
    out = run(*_resize(named, h, hp, widen).values(), scale=scale, **kw)
    return _resize(out, h, hp, narrow)


def segment_scan_dot_bwd(u_h, u_o, hprev_h, hprev_o, m_h, m_o, gates_h, gates_o, atts,
                         g_h, g_o, g_att, w_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
                         scale: float, route=None):
    """The dict of BWD_OUTPUTS (see segment_scan_dot_bwd_plain) for the
    upstream gradients g_h (2, T, B, H, h), g_o and g_att (2, T, B, H, O);
    CPU tensors take the plain version, CUDA tensors the kernel, at any h
    (segment_scan_dot_bwd_padded). In bfloat16 the kernel's route follows
    the shape at the launched width (bwd_plan: two launches a step, the
    first a cluster launch, at h <= 512, else three); route 'steps' takes
    the per-step route at any shape, 'cluster' raises where the shape does
    not take it (the card tests hold the two routes to the same bits).
    Float32 takes the per-step route."""
    args = dict(u_h=u_h, u_o=u_o, hprev_h=hprev_h, hprev_o=hprev_o, m_h=m_h, m_o=m_o,
                gates_h=gates_h, gates_o=gates_o, atts=atts, g_h=g_h, g_o=g_o, g_att=g_att,
                w_from=w_from, w_msg_h=w_msg_h, w_msg_o=w_msg_o, w_hh_h=w_hh_h, w_hh_o=w_hh_o)
    _build.refuse_autograd("segment_scan_dot_bwd", *args.values())
    if route not in (None,) + BWD_ROUTES:
        raise ValueError(f"segment_scan_dot_bwd: route {route!r} is not one of {BWD_ROUTES}")
    if hprev_h.device.type == "cpu":
        return segment_scan_dot_bwd_plain(**args, scale=scale)
    if hprev_h.device.type != "cuda":
        raise ValueError(f"segment_scan_dot_bwd runs on CUDA or the CPU, not {hprev_h.device}")
    _, t, b, nh, h = hprev_h.shape
    _check("segment_scan_dot_bwd", args, (t, b, nh, hprev_o.shape[3], h),
           io_dtypes=(torch.float32, torch.bfloat16))
    return segment_scan_dot_bwd_padded(_launch_segment_scan_dot_bwd, *args.values(),
                                       scale=scale, route=route)


def _launch_segment_scan_dot_bwd(*args, scale, route):
    """K4 on checked tensors (BWD_INPUTS) at an aligned width."""
    args = dict(zip(BWD_INPUTS, args))
    hprev_h, hprev_o = args["hprev_h"], args["hprev_o"]
    _, t, b, nh, h = hprev_h.shape
    no = hprev_o.shape[3]
    io = hprev_h.dtype
    dev = hprev_h.device
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, device=dev, dtype=dtype)
    out = dict(dgi_h=empty(2, t, b, nh, 3 * h, dtype=io), dgi_o=empty(2, t, b, no, 3 * h, dtype=io),
               dgh_h=empty(2, t, b, nh, 3 * h, dtype=io), dgh_o=empty(2, t, b, no, 3 * h, dtype=io),
               dpre_h=empty(2, t, b, nh, 2 * h, dtype=io),
               dpre_o=empty(2, t, b, no, 2 * h, dtype=io),
               du_h=empty(2, t, b, nh, dtype=io), du_o=empty(2, t, b, no, dtype=io),
               dh0_h=empty(2, b, nh, h, dtype=io), dh0_o=empty(2, b, no, h, dtype=io))
    if t == 0:
        out["dh0_h"].zero_()
        out["dh0_o"].zero_()
        return out
    cluster = False
    if io == torch.bfloat16:
        takes = bool(bwd_plan(b, nh, no, h, occupancy=False)["route"])
        if route == "cluster" and not takes:
            raise ValueError(f"segment_scan_dot_bwd: the shape (B={b}, H={nh}, O={no}, h={h}) "
                             "does not take the cluster route")
        cluster = takes and route != "steps"
    elif route == "cluster":
        raise ValueError("segment_scan_dot_bwd: the cluster route is bfloat16's")
    col_tiles = -(-h // 16)                 # the carry phase's blocks per row
    scratch = [empty(2, t, b * nh, col_tiles), empty(2, t, b * no, col_tiles),   # du partials
               empty(2, b * nh, h), empty(2, b * no, h)]                         # dhz
    if cluster:
        scratch += [None] * 4 + [empty(2, b, nh + no, nh + no)]                  # ds
    else:
        scratch += [empty(2, b * nh, 2 * h), empty(2, b * no, 2 * h),           # dmsgs
                    empty(2, b * nh, h), empty(2, b * no, h)]                    # attc
        scratch += [None] if io == torch.bfloat16 else []                       # no ds
    ptrs = [x.data_ptr() if x is not None else None
            for x in (*args.values(), *(out[k] for k in BWD_OUTPUTS), *scratch)]
    lib = _build.load_library("segment_scan_bwd")
    if io == torch.float32:
        fn = lib.tggcn_segment_scan_dot_bwd_f32
        fn.argtypes = [_P] * len(ptrs) + [_I] * 5 + [ctypes.c_float, _P]
        extra = ()
    else:
        fn = lib.tggcn_segment_scan_dot_bwd_bf16
        fn.argtypes = [_P] * len(ptrs) + [_I] * 6 + [ctypes.c_float, _P]
        extra = (int(cluster),)
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, *extra, t, b, nh, no, h, float(scale), stream)
    _build.check_launch(err, "segment_scan_dot_bwd")
    _build.count_launch(segment_scan_dot_bwd, io)
    return out


segment_scan_dot_bwd.launches = segment_scan_dot_bwd.launches_bf16 = 0

class SegmentScanDot(torch.autograd.Function):
    """K3 forward, keeping what K4 reads; K4 backward; the weight gradients
    reduced outside."""

    @staticmethod
    def forward(ctx, scale, use_kernels, *args):
        run = segment_scan_dot if use_kernels else segment_scan_dot_plain
        out_h, out_o, att, *kept = run(*args, scale=scale, keep=True)
        ctx.save_for_backward(*args, out_h, out_o, *kept)
        ctx.scale, ctx.use_kernels = scale, use_kernels
        return out_h, out_o, att

    @staticmethod
    def backward(ctx, g_h, g_o, g_att):
        saved = ctx.saved_tensors
        (gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o,
         b_hh_h, b_hh_o, obj_mask, h0_h, h0_o, out_h, out_o) = saved[:17]
        kept = dict(zip(KEPT, saved[17:]))
        zeros = lambda like, g: torch.zeros_like(like) if g is None else g.contiguous()
        g_h, g_o = zeros(out_h, g_h), zeros(out_o, g_o)
        g_att = zeros(gi_h[..., :obj_mask.shape[1]], g_att)
        hprev_h, hprev_o = previous_states(out_h, h0_h), previous_states(out_o, h0_o)
        run = segment_scan_dot_bwd if ctx.use_kernels else segment_scan_dot_bwd_plain
        grads = run(u_h, u_o, hprev_h, hprev_o, kept["m_h"], kept["m_o"], kept["gates_h"],
                    kept["gates_o"], kept["atts"], g_h, g_o, g_att, w_from, w_msg_h, w_msg_o,
                    w_hh_h, w_hh_o, ctx.scale)
        weights = segment_scan_dot_weight_grads(hprev_h, hprev_o, kept["mix_h"], kept["mix_o"],
                                                grads)
        return (None, None, grads["dgi_h"], grads["dgi_o"], grads["du_h"].sum(0),
                grads["du_o"].sum(0), *weights, None, grads["dh0_h"], grads["dh0_o"])


def segment_scan_dot_autograd(gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o,
                              w_hh_h, w_hh_o, b_hh_h, b_hh_o, obj_mask, h0_h, h0_o,
                              scale: float, use_kernels: bool = True):
    """The differentiable scan (h_h, h_o, att_oh). use_kernels=False runs
    the plain forward and backward on any device (the reference). When no
    gradient will be taken (grad disabled, or no input requires one) the
    forward keeps nothing for a backward."""
    args = (gi_h, gi_o, u_h, u_o, w_from, b_from, w_msg_h, w_msg_o, w_hh_h, w_hh_o, b_hh_h,
            b_hh_o, obj_mask, h0_h, h0_o)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in args)):
        run = segment_scan_dot if use_kernels else segment_scan_dot_plain
        return run(*args, scale=scale, keep=False)
    return SegmentScanDot.apply(scale, use_kernels, *args)
