"""Linear layers, MLPs with name-based activations, and bilinear layers.

Counterpart of ``tggcn/nn/mlp.py:18-100``. Weights are stored as (in, out),
as in the JAX pytree, so ``x @ w`` reads the same leaves.
"""

from typing import Optional, Sequence, Union

import torch

from tggcn_torch.nn.init import fan_in_uniform


def init_linear(generator, in_dim: int, out_dim: int, bias: bool = True) -> dict:
    params = {"w": fan_in_uniform(generator, (in_dim, out_dim), in_dim)}
    if bias:
        params["b"] = fan_in_uniform(generator, (out_dim,), in_dim)
    return params


def apply_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def pick_activation(activation: Union[str, dict, None]):
    if activation is None:
        return lambda x: x
    if isinstance(activation, dict):
        name = activation["name"]
        kwargs = {k: v for k, v in activation.items() if k != "name"}
    else:
        name, kwargs = activation, {}
    name = name.lower()
    if name == "identity":
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    if name == "logsoftmax":
        return lambda x: torch.log_softmax(x, dim=kwargs.get("dim", -1))
    raise ValueError(f"Unknown activation: {name}")


def init_mlp(generator, dims: Sequence[int], bias: bool = True) -> dict:
    return {"layers": [init_linear(generator, d_in, d_out, bias=bias)
                       for d_in, d_out in zip(dims[:-1], dims[1:])]}


def apply_mlp(params: dict, x: torch.Tensor,
              activations: Optional[Sequence[Union[str, dict]]] = None) -> torch.Tensor:
    """Forward (eval) pass of an MLP: dropout is a training feature."""
    layers = params["layers"]
    if activations is None:
        activations = ["identity"] * len(layers)
    if len(layers) != len(activations):
        raise ValueError("Number of activations must match the number of layers.")
    for layer, activation in zip(layers, activations):
        x = pick_activation(activation)(apply_linear(layer, x))
    return x


def init_bilinear(generator, in1: int, in2: int, out: int, bias: bool = True) -> dict:
    """Bilinear layer y = x1^T A x2 + b (torch nn.Bilinear semantics), with
    A stored as (out, in1, in2)."""
    params = {"w": fan_in_uniform(generator, (out, in1, in2), in1)}
    if bias:
        params["b"] = fan_in_uniform(generator, (out,), in1)
    return params


def apply_bilinear(params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1 (..., in1), x2 (..., in2) -> (..., out)."""
    y = torch.einsum("...i,oij,...j->...o", x1, params["w"], x2)
    if "b" in params:
        y = y + params["b"]
    return y
