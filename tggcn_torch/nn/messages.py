"""Entity-to-entity messages with attention (counterpart of
``tggcn/nn/messages.py:30-199``).

Every message kind of the reference:
  * relational ('v1'): ``f(sum_s mask * g([receiver, sender]))``, with no
    attention;
  * non-relational ('v2') with 'generic' granularity (the sender alone) or
    'specific' ([receiver, sender]), aggregated by attention in every style
    (v1 concat MLP, v2 dot, v3 scaled dot, v4 bilinear + ReLU), by
    inverse-distance attention, or by mean pooling.
``message_mask`` and ``aggregate_messages`` split ``compute_message_features``
in two, so that a scan can build its masks and its distance weights once
for every step.
"""

import math
from typing import Optional, Tuple

import torch

from tggcn_torch.nn.mlp import apply_bilinear, apply_mlp

RELATIONAL = {"v1", "relational"}
NON_RELATIONAL = {"v2", "non_relational", "non-relational"}
GENERIC = {"v1", "generic"}
SPECIFIC = {"v2", "specific"}
MEAN_POOLING = {"mp", "mean_pooling"}


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


def message_mask(receivers: torch.Tensor, senders: torch.Tensor,
                 senders_mask: Optional[torch.Tensor],
                 exclude_self: bool = False) -> torch.Tensor:
    """The (..., R, S) sender mask of R receivers (..., R, F) and S senders
    (..., S, F), in the receivers' dtype: senders_mask (..., S) or (..., R,
    S), or None (every sender real); exclude_self masks out sender j for
    receiver j (R == S)."""
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
    return mask_rs


def aggregate_messages(params: dict, receivers: torch.Tensor, senders: torch.Tensor,
                       mask_rs: torch.Tensor, *, message_type: str,
                       message_granularity: str, message_aggregation: str,
                       attention_style: str, weights: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """compute_message_features with its sender mask mask_rs (..., R, S)
    made (message_mask); weights, where given, are the distance-based
    attention weights (..., R, S),
    ``distance_based_attention_weights(distances, mask_rs)``."""
    if message_type in RELATIONAL:
        pairs = apply_mlp(params["g"], torch.cat(_pairs(receivers, senders), dim=-1),
                          activations=["relu"]) * mask_rs[..., None]
        return apply_mlp(params["f"], torch.sum(pairs, dim=-2), activations=["relu"]), None
    if message_type not in NON_RELATIONAL:
        raise ValueError(f"unknown message_type {message_type!r}")
    if message_granularity in GENERIC:
        msgs = apply_mlp(params["msg"], senders, activations=["relu"])    # (..., S, H)
        msgs = msgs[..., None, :, :] * mask_rs[..., None]                 # (..., R, S, H)
    elif message_granularity in SPECIFIC:
        msgs = apply_mlp(params["msg"], torch.cat(_pairs(receivers, senders), dim=-1),
                         activations=["relu"]) * mask_rs[..., None]
    else:
        raise ValueError(f"unknown message_granularity {message_granularity!r}")
    if message_aggregation in MEAN_POOLING:
        num_real = torch.clamp(torch.sum(mask_rs, dim=-1, keepdim=True), min=1.0)
        return torch.sum(msgs, dim=-2) / num_real, None
    att = weights
    if att is None:
        att = attention_weights(receivers, senders, mask_rs, attention_style,
                                params.get("att"))
    return torch.sum(att[..., None] * msgs, dim=-2), att


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
        params - {'g', 'f': MLP params} of a relational edge, or {'msg': MLP
            params, 'att': attention params (an MLP for v1, a bilinear layer
            for v4)} of a non-relational one.
        receivers - (..., R, F) receiver features.
        senders - (..., S, F) sender features.
        senders_mask - (..., S) or (..., R, S) real/virtual mask, or None.
        exclude_self - mask out sender j for receiver j (requires R == S).
        distances - (..., R, S) distances for distance-based attention.
    Returns:
        (message (..., R, H_out), attention weights (..., R, S), or None
        for relational messages and under mean pooling).
    """
    mask_rs = message_mask(receivers, senders, senders_mask, exclude_self)
    weights = None if distances is None else distance_based_attention_weights(distances,
                                                                              mask_rs)
    return aggregate_messages(params, receivers, senders, mask_rs, message_type=message_type,
                              message_granularity=message_granularity,
                              message_aggregation=message_aggregation,
                              attention_style=attention_style, weights=weights)
