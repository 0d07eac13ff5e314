"""Discrete segmentation decisions (counterpart of
``tggcn/nn/distributions.py:14-61``).

Both strategies give hard 0/1 decisions with a straight-through gradient,
``x + (hard - x).detach()``. The Gumbel-sigmoid strategy ('gs') takes its
Gumbel noise, shaped (..., 2) like the probabilities [p, 1 - p], as a
tensor, or draws it from an explicit ``torch.Generator``: ``jax.random``'s
draws cannot be reproduced, so a comparison with JAX passes in what JAX drew.
"""

from typing import Optional, Tuple

import torch

GUMBEL_STRATEGIES = ("gumbel-sigmoid", "gs")


def straight_through_estimator(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Hard threshold in the forward pass, identity gradient in the backward."""
    hard = (x > threshold).to(x.dtype)
    return x + (hard - x).detach()


def gumbel_noise(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U uniform in [tiny, 1), on
    the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def straight_through_gumbel_sigmoid(probabilities: torch.Tensor, noise: torch.Tensor,
                                    temperature: float = 1.0,
                                    threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hard, soft) Gumbel-sigmoid decisions; probabilities (..., 1), noise (..., 2)."""
    probs = torch.cat([probabilities, 1.0 - probabilities], dim=-1)
    y = torch.softmax((torch.log(probs + 1e-20) + noise) / temperature, dim=-1)[..., :1]
    return straight_through_estimator(y, threshold), y


def discrete_estimator(x: torch.Tensor, strategy: str = "straight-through",
                       threshold: float = 0.5, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hard, soft) decisions. 'gs' uses ``noise`` (x.shape[:-1] + (2,))
    when given, else draws it from ``generator``."""
    if strategy in {"straight-through", "st"}:
        return straight_through_estimator(x, threshold), x
    if strategy in GUMBEL_STRATEGIES:
        if noise is None:
            if generator is None:
                raise ValueError("gumbel-sigmoid strategy requires noise or a generator.")
            noise = gumbel_noise(x.shape[:-1] + (2,), generator, x.dtype)
        return straight_through_gumbel_sigmoid(x, noise.to(x.dtype), threshold=threshold)
    raise ValueError(
        f"unknown discrete-estimator strategy {strategy!r}; expected "
        "'straight-through'/'st' or 'gumbel-sigmoid'/'gs'.")
