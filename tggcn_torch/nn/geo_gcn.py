"""Geometry-level graph convolution (counterpart of ``tggcn/nn/geo_gcn.py:37``).

BatchNorm over (node, channel), two embeddings 4 -> 64 -> 64, a similarity
adjacency softmax((h W1)(h W2)^T) per (batch, time) with 64 -> 128
projections, then S @ h @ W. Everything after the BatchNorm is
``tggcn_torch.ops.geo_gcn.geo_gcn_plain``; with ``fused`` (the
``use_pallas_geo_gcn`` knob) it runs through the fused kernel K6 instead.
"""

import torch

from tggcn_torch.nn.batchnorm import apply_batchnorm, init_batchnorm
from tggcn_torch.nn.init import fan_in_uniform
from tggcn_torch.nn.mlp import init_linear
from tggcn_torch.ops.geo_gcn import geo_gcn_fused_autograd, geo_gcn_plain


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


def apply_geo_gcn(params: dict, x: torch.Tensor, train: bool = False, fused: bool = False,
                  use_kernels: bool = True, shard=None):
    """x (batch, time, nodes, in_channels) -> ((batch, time, nodes, out), bn_state);
    train normalises with the batch statistics and updates the running ones.
    fused runs the block after the BatchNorm through K6 (its plain version
    with use_kernels=False or on the CPU). ``shard``: the BatchNorm's
    data-parallel statistics (``apply_batchnorm``)."""
    x, bn_state = apply_batchnorm(params["bn"], x, reduce_axes=(0, 1), train=train,
                                  shard=shard)
    weights = [params[name][key] for name in ("embed1", "embed2", "s1", "s2")
               for key in ("w", "b")] + [params["weight"]]
    if not fused:
        return geo_gcn_plain(x, *weights), bn_state
    b, t, v, c = x.shape
    out = geo_gcn_fused_autograd(x.reshape(b * t, v, c), *weights, use_kernels=use_kernels)
    return out.reshape(b, t, v, -1), bn_state
