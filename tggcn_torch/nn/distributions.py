"""Discrete segmentation decisions (counterpart of
``tggcn/nn/distributions.py:14-61``).

Both strategies give hard 0/1 decisions with a straight-through gradient,
``x + (hard - x).detach()``. The Gumbel-sigmoid strategy ('gs') takes its
Gumbel noise, shaped (..., 2) like the probabilities [p, 1 - p], as a
tensor, or draws it from an explicit ``torch.Generator``: ``jax.random``'s
draws cannot be reproduced, so a comparison with JAX passes in what JAX drew.

Frame-indexed noise (``gs_noise='frame_indexed'``, the counterpart of
``tggcn/nn/distributions.py:20-33``) must depend only on a key and the
absolute frame, so that a sliding window draws what the whole clip draws.
JAX folds the frame into its key; the port hashes (key, stream, frame,
the element's place in the frame) with splitmix64 in int64 tensor
arithmetic on the device (``frame_indexed_gumbel``) and maps the top 53
bits to a uniform in (0, 1). It matches JAX in distribution and in
window invariance, not bit for bit.
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


# splitmix64's constants as int64 (two's complement); tensor arithmetic in
# int64 wraps modulo 2**64 on the CPU and on CUDA alike.
_GAMMA = 0x9E3779B97F4A7C15 - 2 ** 64
_MIX1 = 0xBF58476D1CE4E5B9 - 2 ** 64
_MIX2 = 0x94D049BB133111EB - 2 ** 64
KEY_BITS = 62


def _shift_right(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The logical right shift of int64 x (torch's >> is arithmetic)."""
    return (x >> bits) & ((1 << (64 - bits)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's output function of the int64 tensor x, elementwise."""
    z = x + _GAMMA
    z = (z ^ _shift_right(z, 30)) * _MIX1
    z = (z ^ _shift_right(z, 27)) * _MIX2
    return z ^ _shift_right(z, 31)


def noise_key(generator: torch.Generator) -> torch.Tensor:
    """A key for frame_indexed_gumbel: one int64 draw on the generator's
    device (read back by nothing)."""
    return torch.randint(0, 2 ** KEY_BITS, (), generator=generator, device=generator.device)


def frame_indexed_gumbel(key: torch.Tensor, stream: int, frames: torch.Tensor, b: int,
                         n: int, dtype=torch.float32) -> torch.Tensor:
    """Gumbel noise (B, T, n, 2) for the absolute frames ``frames`` (T,):
    element (i, t, e, k) is a function of (key, stream, frames[t], its place
    (i * n + e) * 2 + k in the frame) alone."""
    per_frame = torch.arange(b * n * 2, device=frames.device).reshape(b, 1, n, 2)
    offset = ((stream + 1) * _GAMMA + 2 ** 63) % 2 ** 64 - 2 ** 63   # as an int64
    stream_key = splitmix64(key.to(frames.device) + offset)
    frame_key = splitmix64(stream_key ^ frames.to(torch.int64))            # (T,)
    z = splitmix64(frame_key[None, :, None, None] ^ per_frame)            # (B, T, n, 2)
    u = (_shift_right(z, 11).to(torch.float64) + 0.5) * 2.0 ** -53
    return (-torch.log(-torch.log(u))).to(dtype)


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
