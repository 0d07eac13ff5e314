"""Batch normalisation with running statistics (counterpart of
``tggcn/nn/batchnorm.py``).

torch BatchNorm1d semantics: eps 1e-5, momentum 0.1; in training the batch
is normalised with its biased variance and the running variance moves
toward the unbiased one. The new running statistics come back beside the
output; in eval they are the old ones.
"""

import torch


def init_batchnorm(shape, device=None) -> dict:
    return {
        "params": {"scale": torch.ones(shape, device=device),
                   "bias": torch.zeros(shape, device=device)},
        "state": {"mean": torch.zeros(shape, device=device),
                  "var": torch.ones(shape, device=device)},
    }


def apply_batchnorm(bn: dict, x: torch.Tensor, reduce_axes, train: bool = False,
                    momentum: float = 0.1, eps: float = 1e-5):
    """Normalise x over reduce_axes; the other axes match the parameter
    shape. Returns (y, state): the updated running statistics when train,
    else the state unchanged."""
    params, state = bn["params"], bn["state"]
    if train:
        mean = torch.mean(x, dim=reduce_axes)
        var = torch.var(x, dim=reduce_axes, correction=0)
        n = 1
        for axis in reduce_axes:
            n *= x.shape[axis]
        with torch.no_grad():
            new_state = {
                "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
                "var": (1.0 - momentum) * state["var"] + momentum * var * n / max(n - 1, 1),
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    shape = [1 if i in reduce_axes else s for i, s in enumerate(x.shape)]
    mean = mean.reshape(shape)
    var = var.reshape(shape)
    scale = params["scale"].reshape(shape)
    bias = params["bias"].reshape(shape)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps)) * scale + bias
    return y, new_state
