"""Geometry-level graph convolution (counterpart of ``tggcn/nn/geo_gcn.py:37``).

BatchNorm over (node, channel), two embeddings 4 -> 64 -> 64, a similarity
adjacency softmax((h W1)(h W2)^T) per (batch, time) with 64 -> 128
projections, then S @ h @ W. Plain PyTorch here: the fused TPU kernel of
this block (``tggcn/ops/geo_gcn_pallas.py``) is off in the configuration
this slice serves.
"""

import torch

from tggcn_torch.nn.batchnorm import apply_batchnorm, init_batchnorm
from tggcn_torch.nn.init import fan_in_uniform
from tggcn_torch.nn.mlp import apply_linear, init_linear


def init_geo_gcn(generator, node_n: int, in_channels: int = 4,
                 out_channels: int = 128) -> dict:
    return {
        "bn": init_batchnorm((node_n, in_channels), device=generator.device),
        "embed1": init_linear(generator, in_channels, 64),
        "embed2": init_linear(generator, 64, 64),
        "s1": init_linear(generator, 64, 128),
        "s2": init_linear(generator, 64, 128),
        "weight": fan_in_uniform(generator, (64, out_channels), out_channels),
    }


def apply_geo_gcn(params: dict, x: torch.Tensor, train: bool = False):
    """x (batch, time, nodes, in_channels) -> ((batch, time, nodes, out), bn_state);
    train normalises with the batch statistics and updates the running ones."""
    x, bn_state = apply_batchnorm(params["bn"], x, reduce_axes=(0, 1), train=train)
    h = torch.relu(apply_linear(params["embed1"], x))
    h = torch.relu(apply_linear(params["embed2"], h))            # (B, T, V, 64)
    s1 = apply_linear(params["s1"], h)                            # (B, T, V, 128)
    s2 = apply_linear(params["s2"], h)
    scores = torch.einsum("btvc,btwc->btvw", s1, s2)
    adjacency = torch.softmax(scores, dim=-1)                     # (B, T, V, V)
    out = torch.einsum("btvw,btwc->btvc", adjacency, h)
    return out @ params["weight"], bn_state
