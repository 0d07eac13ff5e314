"""GRU cells and the multi-stream frame-level BiGRU.

Counterpart of ``tggcn/nn/gru.py:35-161``. Gate math follows torch's GRU:
gate order r, z, n; ``n = tanh(i_n + r * (h W_hn + b_hn))``;
``h' = (1 - z) * n + z * h``. The input projection of the whole sequence is
one large matmul outside the recurrence; the recurrence itself runs
through ``gru_sequence_autograd`` (``tggcn_torch/ops/gru_sequence.py``): the
K1 kernel forward and the K2 kernel backward, in float32 or bfloat16 (the
inputs' dtype, which the weights are cast to).
"""

from typing import Optional, Sequence

import torch

from tggcn_torch.nn.init import fan_in_uniform
from tggcn_torch.ops.gru_sequence import gru_sequence_autograd


def init_gru_cell(generator, input_size: int, hidden_size: int,
                  bias: bool = True) -> dict:
    params = {
        "w_ih": fan_in_uniform(generator, (input_size, 3 * hidden_size), hidden_size),
        "w_hh": fan_in_uniform(generator, (hidden_size, 3 * hidden_size), hidden_size),
    }
    if bias:
        params["b_ih"] = fan_in_uniform(generator, (3 * hidden_size,), hidden_size)
        params["b_hh"] = fan_in_uniform(generator, (3 * hidden_size,), hidden_size)
    return params


def init_bigru(generator, input_size: int, hidden_size: int,
               bias: bool = True) -> dict:
    return {"fwd": init_gru_cell(generator, input_size, hidden_size, bias=bias),
            "bwd": init_gru_cell(generator, input_size, hidden_size, bias=bias)}


def run_multi_bigru(params_list: Sequence[dict], xs_list: Sequence[torch.Tensor],
                    h0_fwd_list: Optional[Sequence[torch.Tensor]] = None,
                    use_kernels: bool = True, bidirectional: bool = True):
    """Several same-width BiGRU streams in one ``gru_sequence`` call.

    Entity rows of each stream (batch x entities) are padded to the widest
    stream; the forward directions of all streams come first and the
    backward directions after them, so one call advances all 2S
    recurrences (the backward ones in reverse time).

    Arguments:
        params_list - per-stream ``{'fwd', 'bwd'}`` GRU params, equal width h.
        xs_list - per-stream inputs (B, T, E_i, F).
        h0_fwd_list - optional per-stream forward initial states (B, E_i, h).
        use_kernels - False runs the plain PyTorch versions of the
            recurrence and its backward on any device (a reference for the
            kernels).
        bidirectional - False runs the 'fwd' cells alone (S recurrences,
            none reversed), as ``tggcn``'s ``run_gru`` on params['fwd'].
    Returns:
        Per-stream outputs (B, T, E_i, 2h), forward then backward features
        ((B, T, E_i, h) without bidirectional).
    """
    num_streams = len(params_list)
    hidden = params_list[0]["fwd"]["w_hh"].shape[0]
    t = xs_list[0].shape[1]
    r_max = max(x.shape[0] * x.shape[2] for x in xs_list)

    def fold(x):                       # (B, T, E, F) -> (R_max, T, F)
        b_, t_, e_, f_ = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b_ * e_, t_, f_)
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, r_max - b_ * e_))

    xs = torch.stack([fold(x) for x in xs_list])                  # (S, R, T, F)
    directions = ("fwd", "bwd") if bidirectional else ("fwd",)
    dirs = [(p, d) for d in directions for p in params_list]      # 2S (or S) cells
    num_reverse = len(dirs) - num_streams
    zeros = xs.new_zeros(3 * hidden)

    def stacked(key):                  # (2S, ...) in the inputs' dtype (gru_pallas.py:251-266)
        return torch.stack([p[d].get(key, zeros) for p, d in dirs]).to(xs.dtype)

    w_ih, w_hh, b_ih, b_hh = (stacked(k) for k in ("w_ih", "w_hh", "b_ih", "b_hh"))

    xs2 = torch.cat([xs] * len(directions))                       # (2S, R, T, F)
    # Batched over the cells only: a weight broadcast over the rows would be
    # copied out for every row and kept for the backward.
    gi = torch.einsum("srtf,sfk->srtk", xs2, w_ih) + b_ih[:, None, None]   # (2S, R, T, 3h)
    gi = gi.permute(2, 0, 1, 3).contiguous()                      # (T, 2S, R, 3h)

    h0 = xs.new_zeros((len(dirs), r_max, hidden))
    if h0_fwd_list is not None:
        h0[:num_streams] = torch.stack([fold(h[:, None])[:, 0] for h in h0_fwd_list]).to(xs.dtype)
    seq = gru_sequence_autograd(gi, w_hh, b_hh, h0, num_reverse=num_reverse,
                                use_kernels=use_kernels)          # (T, 2S, R, h)
    out = torch.cat([seq[:, :num_streams], seq[:, num_streams:]], dim=-1) if num_reverse else seq
    width = out.shape[-1]

    results = []
    for i, x in enumerate(xs_list):
        b_, _, e_, _ = x.shape
        stream = out[:, i, : b_ * e_]                             # (T, B*E, 2h)
        stream = stream.permute(1, 0, 2).reshape(b_, e_, t, width)
        results.append(stream.transpose(1, 2))                    # (B, T, E, 2h)
    return results
