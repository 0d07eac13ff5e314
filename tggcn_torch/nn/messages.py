"""Entity-to-entity messages with attention (counterpart of
``tggcn/nn/messages.py:30-199``).

The port covers non-relational generic messages (``message_type`` v2,
``message_granularity`` v1), aggregated by attention in every style (v1
concat MLP, v2 dot, v3 scaled dot, v4 bilinear + ReLU), by inverse-distance
attention, or by mean pooling. Relational and 'specific' messages raise.
"""

import math
from typing import Optional, Tuple

import torch

from tggcn_torch.nn.mlp import apply_bilinear, apply_mlp

SLICE = "the port (non-relational generic messages)"


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to unmasked senders.

    A finite big-negative fill, an explicit mask multiply and a clamped
    denominator: a fully masked row gives all-zero weights, never NaN (an
    all -inf row would give NaN through inf - inf).
    """
    maskf = torch.broadcast_to(mask, scores.shape).to(scores.dtype)
    scores = torch.where(maskf > 0, scores, scores.new_full((), -1e30))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m) * maskf
    d = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp(d, min=1e-30)


def _pairs(query: torch.Tensor, keys: torch.Tensor):
    """query and keys broadcast to (..., R, S, F) each."""
    r, s = query.shape[-2], keys.shape[-2]
    q = torch.broadcast_to(query[..., :, None, :], query.shape[:-2] + (r, s, query.shape[-1]))
    k = torch.broadcast_to(keys[..., None, :, :], keys.shape[:-2] + (r, s, keys.shape[-1]))
    return q, k


def attention_weights(query: torch.Tensor, keys: torch.Tensor, keys_mask: torch.Tensor,
                      attention_style: str,
                      attention_params: Optional[dict] = None) -> torch.Tensor:
    """Attention weights (..., R, S) for query (..., R, F), keys (..., S, F)
    and keys_mask broadcastable to (..., R, S)."""
    if attention_style in {"v1", "concat"}:
        q, k = _pairs(query, keys)
        scores = apply_mlp(attention_params, torch.cat([q, k], dim=-1),
                           activations=["relu"])[..., 0]
    elif attention_style in {"v2", "dot-product", "v3", "scaled_dot-product"}:
        scores = torch.einsum("...rf,...sf->...rs", query, keys)
        if attention_style in {"v3", "scaled_dot-product"}:
            scores = scores / math.sqrt(keys.shape[-1])
    elif attention_style in {"v4", "general"}:
        q, k = _pairs(query, keys)
        scores = torch.relu(apply_bilinear(attention_params, q, k)[..., 0])
    else:
        raise ValueError(f"unknown attention_style {attention_style!r}")
    return masked_softmax(scores, keys_mask)


def distance_based_attention_weights(distances: torch.Tensor,
                                     senders_mask: torch.Tensor) -> torch.Tensor:
    """Inverse-distance attention (..., R, S): softmax over 1 / (d + 1e-7),
    with zero distances masked beside the masked senders; a fully masked row
    gives zeros. A NaN distance compares unequal to 0 and stays in."""
    combined = (senders_mask != 0) & (distances != 0)
    return masked_softmax(1.0 / (distances + 1e-7), combined)


def compute_message_features(
    params: dict,
    receivers: torch.Tensor,
    senders: torch.Tensor,
    senders_mask: Optional[torch.Tensor],
    *,
    message_type: str,
    message_granularity: str,
    message_aggregation: str,
    attention_style: str,
    exclude_self: bool = False,
    distances: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Messages from S senders to each of R receivers.

    Arguments:
        params - {'msg': MLP params, 'att': attention params (an MLP for
            v1, a bilinear layer for v4)} of one edge type.
        receivers - (..., R, F) receiver features.
        senders - (..., S, F) sender features.
        senders_mask - (..., S) or (..., R, S) real/virtual mask, or None.
        exclude_self - mask out sender j for receiver j (requires R == S).
        distances - (..., R, S) distances for distance-based attention.
    Returns:
        (message (..., R, H_out), attention weights (..., R, S), or None
        under mean pooling).
    """
    if message_type in {"v1", "relational"} or message_granularity not in {"v1", "generic"}:
        raise NotImplementedError(
            f"message ({message_type}, {message_granularity}) is outside {SLICE}")
    r, s = receivers.shape[-2], senders.shape[-2]
    if senders_mask is None:
        mask_rs = receivers.new_ones(receivers.shape[:-2] + (r, s))
    else:
        if senders_mask.dim() == receivers.dim() - 1:     # (..., S)
            senders_mask = senders_mask[..., None, :]
        mask_rs = torch.broadcast_to(senders_mask, senders_mask.shape[:-2] + (r, s))
        mask_rs = mask_rs.to(receivers.dtype)
    if exclude_self:
        if r != s:
            raise ValueError("exclude_self requires R == S")
        mask_rs = mask_rs * (1.0 - torch.eye(r, dtype=mask_rs.dtype,
                                             device=mask_rs.device))
    msgs = apply_mlp(params["msg"], senders, activations=["relu"])    # (..., S, H)
    msgs = msgs[..., None, :, :] * mask_rs[..., None]                 # (..., R, S, H)
    if message_aggregation in {"mp", "mean_pooling"}:
        num_real = torch.clamp(torch.sum(mask_rs, dim=-1, keepdim=True), min=1.0)
        return torch.sum(msgs, dim=-2) / num_real, None
    if distances is None:
        att = attention_weights(receivers, senders, mask_rs, attention_style,
                                params.get("att"))
    else:
        att = distance_based_attention_weights(distances, mask_rs)
    return torch.sum(att[..., None] * msgs, dim=-2), att
