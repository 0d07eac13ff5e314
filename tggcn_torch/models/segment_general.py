"""The general segment scan in plain PyTorch: the counterpart of JAX's XLA
route ``tggcn/models/tggcn.py::_segment_scan`` (``:1047-1214``).

JAX runs it wherever its fast path does not apply (``:819-831``): a
segment level without all four entity edges (CAD-120's one human and no
humans-to-human edge), ``message_segment=False``, relational or 'specific'
messages; the port also runs it for a partial set of distance tensors
(CAD-120 gives only the human-object and object-object ones), which JAX's
kernel route leaves to XLA. No TPU kernel runs it, so it has no kernel
here: autograd takes its backward.

Semantics, step by step as JAX's: the forward step ``tf = i`` and the
backward step ``tb = T-1-i`` in lockstep; every segment message reads the
carry (the states committed through the previous step); humans-to-human
and objects-to-object messages exclude self, and the object mask masks
the objects as senders; the objects receive from the humans along the
swapped human-object distances; the commit is ``u h_new + (1 - u) h_prev``;
the forward carry starts from ``seg_carry``, the backward one from zeros.
Everything runs in the compute dtype of the inputs, as JAX's scan does
(``dtype = x_hs.dtype``): the products, the GRU's gate arithmetic, the
commit and the carried states, which in a bfloat16 model are rounded to
bfloat16 every step. (The kernels K1, K3 and K5 carry float32 states in a
bfloat16 model; this scan follows JAX's XLA route instead.)

Both directions advance in one set of operations: their states are stacked
on a leading axis (the message parameters are shared by the directions,
the cells are stacked per direction), the backward direction's inputs
flipped in time. The masks and the distance-based attention weights, which
no state changes, are made once for every step before the loop. The loop
over T makes no host read and takes no data-dependent branch, so a CUDA
graph can capture it.
"""

import torch

from tggcn_torch.nn.messages import (MEAN_POOLING, RELATIONAL, aggregate_messages,
                                     distance_based_attention_weights, message_mask)

# The torch.profiler range that apply_tggcn opens around the scan:
# profile_step reads its forward's device time, and its backward's by the
# autograd nodes made inside it.
GENERAL_SCAN_RANGE = "segment_scan_general"
HUMAN_CELLS = ("human_segment_rnn_fcell", "human_segment_rnn_bcell")
OBJECT_CELLS = ("object_segment_rnn_fcell", "object_segment_rnn_bcell")


def _both_directions(x):
    """(B, T, ...) -> (T, 2, B, ...): time order, then flipped in time (the
    backward direction's order)."""
    x = x.movedim(1, 0)
    return torch.stack([x, x.flip(0)], dim=1)


def _cell_weights(params, cells, base):
    """The message part of the input weights (2, F_msg, 3h), the recurrent
    weights (2, h, 3h) and biases (2, 3h) of a direction pair of cells."""
    zeros = params[cells[0]]["w_hh"].new_zeros(params[cells[0]]["w_hh"].shape[-1])
    return (torch.stack([params[c]["w_ih"][base:] for c in cells]),
            torch.stack([params[c]["w_hh"] for c in cells]),
            torch.stack([params[c].get("b_hh", zeros) for c in cells]))


def _gru_commit(gi, msgs, w_msg, w_hh, b_hh, h, u):
    """One GRU step of both directions (``tggcn/nn/gru.py:43``
    ``gru_step_from_gates``) from the hoisted input gates gi (2, B, E, 3h),
    the messages (2, B, E, F_msg) or None and the carried states h (2, B,
    E, h), committed where u (2, B, E, 1) is 1: all in the compute dtype."""
    # Batched over the direction axis only: a weight broadcast over (B,
    # E) would be copied out for every batch row and kept for the backward.
    if msgs is not None:
        gi = gi + torch.einsum("dbef,dfk->dbek", msgs, w_msg)
    gh = torch.einsum("dbeh,dhk->dbek", h, w_hh) + b_hh[:, None, None]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = (1.0 - z) * n + z * h
    return u * h_new + (1.0 - u) * h


def segment_scan_general(params, cfg, x_hs, x_os, u_h, u_o, objects_mask, hh=None, ho=None,
                         oo=None, seg_carry=(None, None)):
    """The gated bidirectional segment scan for any configuration:
    x_hs (B, T, H, F_h), x_os (B, T, O, F_o), decisions u_h (B, T, H), u_o
    (B, T, O), objects_mask (B, O), the (B, T, R, S) distances hh, ho, oo
    of distance-based attention (any of them, or none) and the forward
    carries seg_carry ((B, H, h) or None, (B, O, h) or None). Returns
    (hx_hs (B, T, H, 2h), hx_os (B, T, O, 2h), att fwd, att bwd (B, T, H,
    O)): each direction's states in time order, and the objects-to-human
    segment attention, zeros where that edge gives none (relational
    messages, mean pooling, no such edge)."""
    b, t, num_humans, base_h = x_hs.shape
    num_objects, base_o = x_os.shape[2], x_os.shape[-1]
    h = cfg.hidden_size
    mkw = cfg.message_kwargs()

    def base_gates(cells, x):
        """The hoisted input gates (T, 2, B, E, 3h) of the part of a cell's
        input that no state changes."""
        gates = []
        for cell in cells:
            c = params[cell]
            gi = x @ c["w_ih"][: x.shape[-1]]
            gates.append(gi + c["b_ih"] if "b_ih" in c else gi)
        fwd, bwd = (g.movedim(1, 0) for g in gates)
        return torch.stack([fwd, bwd.flip(0)], dim=1)

    gi_h, gi_o = base_gates(HUMAN_CELLS, x_hs), base_gates(OBJECT_CELLS, x_os)
    u_h2, u_o2 = _both_directions(u_h)[..., None], _both_directions(u_o)[..., None]
    cell_h, cell_o = _cell_weights(params, HUMAN_CELLS, base_h), _cell_weights(params,
                                                                               OBJECT_CELLS,
                                                                               base_o)

    dtype = x_hs.dtype
    seg_h0, seg_o0 = seg_carry
    h_h = x_hs.new_zeros((2, b, num_humans, h))          # (direction, B, H, h)
    h_o = x_hs.new_zeros((2, b, num_objects, h))
    if seg_h0 is not None:
        h_h = torch.cat([seg_h0[None].to(dtype), h_h[1:]])
    if seg_o0 is not None:
        h_o = torch.cat([seg_o0[None].to(dtype), h_o[1:]])

    # The segment edges of each receiver type, in the order of JAX's
    # message concatenation: (name, senders are humans, sender mask,
    # exclude self, distances (B, T, R, S)).
    obj_mask = objects_mask[None, :, None, :]                  # (1, B, 1, O)
    oh = None if ho is None else ho.transpose(2, 3)
    edges_h = [("h2h", True, None, True, hh), ("o2h", False, obj_mask, False, ho)]
    edges_o = [("h2o", True, None, False, oh), ("o2o", False, obj_mask, True, oo)]
    flags = {"h2h": cfg.message_humans_to_human, "o2h": cfg.message_objects_to_human,
             "h2o": cfg.message_human_to_objects, "o2o": cfg.message_objects_to_object}
    with_weights = (cfg.message_type not in RELATIONAL
                    and cfg.message_aggregation not in MEAN_POOLING)

    def prepare(edges, receivers):
        """(name, senders are humans, mask (., B, R, S), distance weights
        (T, 2, B, R, S) or None) of each edge that is on."""
        out = []
        for name, from_humans, mask, exclude, dists in edges:
            if not (cfg.message_segment and flags[name]):
                continue
            mask_rs = message_mask(receivers, h_h if from_humans else h_o, mask,
                                   exclude).to(dtype)
            weights = None
            if with_weights and dists is not None:
                weights = distance_based_attention_weights(_both_directions(dists), mask_rs)
            out.append((name, from_humans, mask_rs, weights))
        return out

    prepared_h, prepared_o = prepare(edges_h, h_h), prepare(edges_o, h_o)

    def messages(prepared, states, receivers, i):
        """The receivers' concatenated segment messages (2, B, R, F_msg) or
        None, and the objects-to-human attention (2, B, H, O) or None, from
        the states (humans', objects') in the compute dtype."""
        parts, att = [], None
        for name, from_humans, mask_rs, weights in prepared:
            msg, a = aggregate_messages(params[name]["segment"], receivers,
                                        states[0] if from_humans else states[1], mask_rs,
                                        weights=None if weights is None else weights[i], **mkw)
            parts.append(msg)
            if name == "o2h":
                att = a
        return (torch.cat(parts, dim=-1) if parts else None), att

    seq_h, seq_o, seq_att = [], [], []
    for i in range(t):
        states = (h_h, h_o)
        msgs_h, att = messages(prepared_h, states, h_h, i)
        msgs_o, _ = messages(prepared_o, states, h_o, i)
        h_h, h_o = (_gru_commit(gi_h[i], msgs_h, *cell_h, h_h, u_h2[i]),
                    _gru_commit(gi_o[i], msgs_o, *cell_o, h_o, u_o2[i]))
        seq_h.append(h_h)
        seq_o.append(h_o)
        seq_att.append(att)

    def order(seq):              # (T, 2, B, E, h) -> (B, T, E, 2h), natural time order
        seq = torch.stack(seq)
        return torch.cat([seq[:, 0].movedim(0, 1), seq[:, 1].flip(0).movedim(0, 1)], dim=-1)

    if seq_att[0] is None:
        zeros = x_hs.new_zeros((b, t, num_humans, num_objects))
        return order(seq_h), order(seq_o), zeros, zeros
    att = torch.stack(seq_att)
    return order(seq_h), order(seq_o), att[:, 0].movedim(0, 1), att[:, 1].flip(0).movedim(0, 1)
