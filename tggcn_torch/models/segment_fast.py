"""The segment scan's fast path in plain PyTorch: the counterpart of JAX's
XLA route ``tggcn/models/tggcn.py::_segment_scan_fast`` (``:834-1046``).

JAX runs this function where no kernel runs the segment scan, and it is
what JAX differentiates for the kernel modes 'v1', 'v4' and 'ext': their
custom VJP recomputes through it (``segment_scan_pallas.py:902-942``). The
port does the same: ``segment_scan_fast`` is the recompute of K5's
backward (``tggcn_torch.models.tggcn._segment_scan_fast``). It is not a
kernel's plain version: it computes every step in the compute dtype, with
states carried in that dtype (bfloat16 in a bfloat16 model, as JAX's zero
carries are, ``:975-976``), where K5 and its plain version carry float32
states.

The time-major scan runs both directions and both entity types at once: the
four cells (humans forward, humans backward, objects forward, objects
backward) stacked on a leading axis with their entity rows padded to
``e_max``, the backward cells reading their inputs flipped in time. Every
mode of JAX's fast path is here: dot (v2, scaled v3), concat (v1), bilinear
(v4) and distance-based attention, and mean pooling; the masked softmax is
the finite one of ``tggcn_torch.nn.messages``. Inputs are flipped and
reordered with ``flip`` and slices, not index gathers, whose backward on
CUDA is an atomic scatter-add that sums in a different order every run.
"""

import math

import torch
import torch.nn.functional as F

from tggcn_torch.nn.messages import distance_based_attention_weights, masked_softmax

# The parameters the segment scan reads (``segment_scan_pallas.py:945``
# ``SEG_PARAM_KEYS``): its four cells and, of the four entity edges, the
# segment-level bundles.
CELLS = ("human_segment_rnn_fcell", "human_segment_rnn_bcell",
         "object_segment_rnn_fcell", "object_segment_rnn_bcell")
EDGES = ("h2h", "h2o", "o2h", "o2o")


def _pad_e(a, target):
    """a (..., E, F) with its entity rows zero-padded to target."""
    return a if a.shape[-2] == target else F.pad(a, (0, 0, 0, target - a.shape[-2]))


def _both_directions(x):
    """(T, ...) -> (T, 2, ...): time order, then flipped in time (the
    backward cells' order)."""
    return torch.stack([x, x.flip(0)], dim=1)


def initial_states(x_hs, n: int, h: int, fwd):
    """(2, B, n, h) initial states in x_hs's dtype: the forward direction's
    from the carry fwd (B, n, h) where given, the backward direction's zero."""
    zeros = x_hs.new_zeros((2, x_hs.shape[0], n, h))
    return zeros if fwd is None else torch.cat([fwd[None].to(x_hs.dtype), zeros[1:]])


def segment_scan_fast(params, cfg, x_hs, x_os, u_h, u_o, objects_mask,
                      hh_dists=None, ho_dists=None, oo_dists=None, seg_carry=(None, None)):
    """The gated bidirectional segment scan, as JAX's ``_segment_scan_fast``:
    x_hs (B, T, H, F_h), x_os (B, T, O, F_o), decisions u_h (B, T, H), u_o
    (B, T, O), objects_mask (B, O), the (B, T, R, S) distances of
    distance-based attention (all three, or none) and the forward
    direction's initial states seg_carry ((B, H, h) or None, (B, O, h) or
    None; the backward direction starts from zero). Returns (hx_hs (B, T, H,
    2h), hx_os (B, T, O, 2h), att fwd, att bwd (B, T, H, O)), each direction's
    states in natural time order, zeros for the attention under mean
    pooling."""
    b, t, num_humans, base_h = x_hs.shape
    num_objects, base_o = x_os.shape[2], x_os.shape[-1]
    h = cfg.hidden_size
    dtype = x_hs.dtype
    scale = 1.0 / math.sqrt(h) if cfg.attention_style in {"v3", "scaled_dot-product"} else 1.0
    mean_pooling = cfg.message_aggregation in {"mp", "mean_pooling"}
    e_max = max(num_humans, num_objects)
    zeros3 = x_hs.new_zeros(3 * h)

    def base_gates(cell, x):
        c = params[cell]
        gi = x @ c["w_ih"][: x.shape[-1]]
        return gi + c["b_ih"] if "b_ih" in c else gi

    # The four cells on a leading axis, time-major (T, 4, B, E, ...), the
    # backward cells' slices flipped in time.
    def four(parts):
        x = torch.stack([_pad_e(p, e_max) for p in parts]).movedim(2, 0)   # (T, 4, B, E, ...)
        return torch.stack([x[:, 0], x[:, 1].flip(0), x[:, 2], x[:, 3].flip(0)], dim=1)

    gi4 = four([base_gates(c, x) for c, x in zip(CELLS, (x_hs, x_hs, x_os, x_os))])
    u4 = four([u[..., None] for u in (u_h, u_h, u_o, u_o)])                 # (T, 4, B, E, 1)
    w_hh4 = torch.stack([params[c]["w_hh"] for c in CELLS])
    b_hh4 = torch.stack([params[c].get("b_hh", zeros3) for c in CELLS])
    w_msg4 = torch.stack([params[c]["w_ih"][base:] for c, base in
                          zip(CELLS, (base_h, base_h, base_o, base_o))])     # (4, 2h, 3h)

    def msg_layer(edge):
        layer = params[edge]["segment"]["msg"]["layers"][0]
        return layer["w"], layer.get("b", x_hs.new_zeros(h))

    w_from_h = torch.stack([msg_layer("h2h")[0], msg_layer("h2o")[0]])     # (2, h, h)
    b_from_h = torch.stack([msg_layer("h2h")[1], msg_layer("h2o")[1]])[:, None, None, None]
    w_from_o = torch.stack([msg_layer("o2h")[0], msg_layer("o2o")[0]])
    b_from_o = torch.stack([msg_layer("o2h")[1], msg_layer("o2o")[1]])[:, None, None, None]

    eye_h = torch.eye(num_humans, dtype=dtype, device=x_hs.device)
    eye_o = torch.eye(num_objects, dtype=dtype, device=x_hs.device)
    obj_mask_r = objects_mask[None, :, None, :]                            # (1, B, 1, O)
    mask_ho = torch.ones((1, 1, num_objects, num_humans), dtype=dtype, device=x_hs.device)

    def edge_attention(recv, send, mask, edge, dists):
        """Attention weights (2, B, R, S) of one edge in the configured style."""
        if mean_pooling:
            full = torch.broadcast_to(mask, (2, b, recv.shape[2], send.shape[2])).to(dtype)
            return full / torch.clamp(full.sum(-1, keepdim=True), min=1.0)
        if dists is not None:
            return distance_based_attention_weights(
                dists, torch.broadcast_to(mask, dists.shape).to(dtype))
        style = cfg.attention_style
        if style in {"v1", "concat"}:
            layer = params[edge]["segment"]["att"]["layers"][0]
            w = layer["w"]
            scores = (recv @ w[:h]) + (send @ w[h:]).transpose(-1, -2)       # (2, B, R, S)
            if "b" in layer:
                scores = scores + layer["b"][0]
            scores = torch.relu(scores)
        elif style in {"v2", "dot-product", "v3", "scaled_dot-product"}:
            scores = torch.einsum("dbnh,dbmh->dbnm", recv, send) * scale
        else:                                                              # v4, bilinear
            bil = params[edge]["segment"]["att"]
            scores = torch.einsum("dbnh,hk,dbmk->dbnm", recv, bil["w"][0], send)
            if "b" in bil:
                scores = scores + bil["b"][0]
            scores = torch.relu(scores)
        return masked_softmax(scores, mask)

    use_dists = not mean_pooling and hh_dists is not None
    if use_dists:
        d_hh, d_ho, d_oo = (_both_directions(d.movedim(1, 0)) for d in (hh_dists, ho_dists,
                                                                         oo_dists))
    h_h2 = initial_states(x_hs, num_humans, h, seg_carry[0])            # (direction, B, H, h)
    h_o2 = initial_states(x_hs, num_objects, h, seg_carry[1])
    seq_h, seq_o, seq_att = [], [], []
    for i in range(t):
        d_hh_e = d_oh_e = d_ho_e = d_oo_e = None
        if use_dists:
            d_hh_e, d_oh_e, d_oo_e = d_hh[i], d_ho[i], d_oo[i]
            d_ho_e = d_oh_e.transpose(-1, -2)
        # Messages from each sender type: both edges and directions in one product.
        m_h = torch.relu(torch.einsum("dbnh,ehk->edbnk", h_h2, w_from_h) + b_from_h)
        m_o = torch.relu(torch.einsum("dbnh,ehk->edbnk", h_o2, w_from_o) + b_from_o)
        a_hh = edge_attention(h_h2, h_h2, (1.0 - eye_h)[None, None], "h2h", d_hh_e)
        mg_hh = torch.einsum("dbnm,dbmh->dbnh", a_hh, m_h[0])
        a_oh = edge_attention(h_h2, h_o2, obj_mask_r, "o2h", d_oh_e)
        mg_oh = torch.einsum("dbnm,dbmh->dbnh", a_oh, m_o[0])
        a_ho = edge_attention(h_o2, h_h2, mask_ho, "h2o", d_ho_e)
        mg_ho = torch.einsum("dbnm,dbmh->dbnh", a_ho, m_h[1])
        a_oo = edge_attention(h_o2, h_o2, obj_mask_r * (1.0 - eye_o)[None, None], "o2o",
                              d_oo_e)
        mg_oo = torch.einsum("dbnm,dbmh->dbnh", a_oo, m_o[1])
        if mean_pooling:
            a_oh = x_hs.new_zeros((2, b, num_humans, num_objects))

        msgs4 = torch.cat([_pad_e(torch.cat([mg_hh, mg_oh], dim=-1), e_max),
                           _pad_e(torch.cat([mg_ho, mg_oo], dim=-1), e_max)])   # (4, B, E, 2h)
        states4 = torch.cat([_pad_e(h_h2, e_max), _pad_e(h_o2, e_max)])
        gi = gi4[i] + torch.einsum("sbnf,sfk->sbnk", msgs4, w_msg4)
        gh = torch.einsum("sbnh,shk->sbnk", states4, w_hh4) + b_hh4[:, None, None]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * states4
        u = u4[i]
        out4 = u * h_new + (1.0 - u) * states4
        h_h2, h_o2 = out4[:2, :, :num_humans], out4[2:, :, :num_objects]
        seq_h.append(h_h2)
        seq_o.append(h_o2)
        seq_att.append(a_oh)

    def order(seq):                  # (T, 2, B, E, h) -> (B, T, E, 2h), natural time order
        return torch.cat([seq[:, 0].movedim(0, 1), seq[:, 1].flip(0).movedim(0, 1)], dim=-1)

    att = torch.stack(seq_att)
    return (order(torch.stack(seq_h)), order(torch.stack(seq_o)), att[:, 0].movedim(0, 1),
            att[:, 1].flip(0).movedim(0, 1))
