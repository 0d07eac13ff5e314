"""Entity-to-entity messages with attention (counterpart of
``tggcn/nn/messages.py:30-199``).

This slice covers non-relational generic messages (``message_type`` v2,
``message_granularity`` v1) aggregated by dot or scaled-dot attention
(``attention_style`` v2/v3). Other message and attention kinds raise.
"""

import math
from typing import Optional, Tuple

import torch

from tggcn_torch.nn.mlp import apply_mlp

SLICE = "the stage-1 slice (non-relational generic messages, dot/scaled-dot attention)"


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to unmasked senders.

    A finite big-negative fill, an explicit mask multiply and a clamped
    denominator: a fully masked row gives all-zero weights, never NaN (an
    all -inf row would give NaN through inf - inf).
    """
    maskf = torch.broadcast_to(mask, scores.shape).to(scores.dtype)
    scores = torch.where(maskf > 0, scores, scores.new_tensor(-1e30))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m) * maskf
    d = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp(d, min=1e-30)


def dot_attention_weights(query: torch.Tensor, keys: torch.Tensor,
                          keys_mask: torch.Tensor, attention_style: str) -> torch.Tensor:
    """(Scaled) dot-product attention weights (..., R, S)."""
    scores = torch.einsum("...rf,...sf->...rs", query, keys)
    if attention_style in {"v3", "scaled_dot-product"}:
        scores = scores / math.sqrt(keys.shape[-1])
    return masked_softmax(scores, keys_mask)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Messages from S senders to each of R receivers.

    Arguments:
        params - {'msg': MLP params} of one edge type.
        receivers - (..., R, F) receiver features.
        senders - (..., S, F) sender features.
        senders_mask - (..., S) or (..., R, S) real/virtual mask, or None.
        exclude_self - mask out sender j for receiver j (requires R == S).
    Returns:
        (message (..., R, H_out), attention weights (..., R, S)).
    """
    if (message_type in {"v1", "relational"}
            or message_granularity not in {"v1", "generic"}
            or message_aggregation not in {"att", "attention"}
            or attention_style not in {"v2", "dot-product", "v3", "scaled_dot-product"}):
        raise NotImplementedError(
            f"message ({message_type}, {message_granularity}, "
            f"{message_aggregation}, {attention_style}) is outside {SLICE}")
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
    att = dot_attention_weights(receivers, senders, mask_rs, attention_style)
    return torch.sum(att[..., None] * msgs, dim=-2), att
