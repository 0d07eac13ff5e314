"""Batch normalisation with running statistics (counterpart of
``tggcn/nn/batchnorm.py``).

torch BatchNorm1d semantics: eps 1e-5, momentum 0.1; in training the batch
is normalised with its biased variance and the running variance moves
toward the unbiased one. The new running statistics come back beside the
output; in eval they are the old ones. Under data parallelism (``shard``,
``tggcn_torch/parallel/distributed.py`` ``BatchShard``) a training batch
is normalised with the statistics of every process's rows: the input (data,
small beside the activations) is gathered, so the statistics are those one
process computes from the global batch, bit for bit.
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
                    momentum: float = 0.1, eps: float = 1e-5, shard=None):
    """Normalise x over reduce_axes; the other axes match the parameter
    shape. Returns (y, state): the updated running statistics when train,
    else the state unchanged. With a shard of more than one process,
    reduce_axes must hold the batch axis 0, x must be data (the global
    statistics carry no gradient), and the mean and the biased variance
    are those of every process's rows, gathered."""
    params, state = bn["params"], bn["state"]
    shape = [1 if i in reduce_axes else s for i, s in enumerate(x.shape)]
    if train:
        whole = x
        if shard is not None and shard.world > 1:
            if x.requires_grad or 0 not in reduce_axes:
                raise ValueError("data-parallel BatchNorm takes data, normalised over the "
                                 "batch axis")
            whole = shard.gather(x)
        n = 1
        for axis in reduce_axes:
            n *= whole.shape[axis]
        mean = torch.mean(whole, dim=reduce_axes)
        var = torch.var(whole, dim=reduce_axes, correction=0)
        with torch.no_grad():
            new_state = {
                "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
                "var": (1.0 - momentum) * state["var"] + momentum * var * n / max(n - 1, 1),
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    mean = mean.reshape(shape)
    var = var.reshape(shape)
    scale = params["scale"].reshape(shape)
    bias = params["bias"].reshape(shape)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps)) * scale + bias
    return y, new_state
