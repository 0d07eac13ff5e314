"""Temporal helpers (counterpart of ``tggcn/nn/temporal.py``): the
local-maximum filter of soft decisions, segment-state reordering, and the
time-position and segment-length features.

Each is written over whole tensors, with no Python loop over time.
"""

import torch


class _Reorder(torch.autograd.Function):
    """h (B, T, H) gathered along time at idx (B, T), with a backward that
    adds each segment's frame gradients in a fixed order.

    ``torch.gather``'s own backward adds the gradients of the frames that
    read one state with atomics on CUDA, in an order that changes from run
    to run. Here the frames that read state k are the contiguous run after
    the previous frame read by itself, so their sum is a difference of
    float64 prefix sums over time: a scan along a dimension that is not the
    innermost, which PyTorch computes column by column in order.
    """

    @staticmethod
    def forward(ctx, h, idx):
        ctx.save_for_backward(idx)
        return torch.gather(h, 1, idx[:, :, None].expand(-1, -1, h.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        steps = torch.arange(idx.shape[1], device=idx.device)
        read = idx == steps                                   # frames some frame reads
        last = torch.cummax(torch.where(read, steps, -1), dim=1).values
        prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
        sums = torch.cumsum(grad.double(), dim=1)
        before = torch.gather(sums, 1, prev.clamp(min=0)[:, :, None].expand_as(sums))
        before = torch.where(prev[:, :, None] >= 0, before, 0.0)
        return torch.where(read[:, :, None], sums - before, 0.0).to(grad.dtype), None


def reorder_hidden_states(h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Label every frame with its segment's final hidden state.

    Arguments:
        h - (B, T, H) segment-level hidden states.
        u - (B, T) hard 0/1 end-of-segment flags.
    Returns:
        (B, T, H): each frame reads the nearest end frame at or after it;
        frames after the last end frame keep their own state.
    """
    t = h.shape[1]
    steps = torch.arange(t, device=h.device)
    candidates = torch.where(u != 0, steps[None, :], torch.full_like(steps, t)[None, :])
    next_end = torch.flip(torch.cummin(torch.flip(candidates, [1]), dim=1).values, [1])
    idx = torch.where(next_end < t, next_end, steps[None, :].expand_as(next_end))
    return _Reorder.apply(h, idx)


def filter_soft_decisions(u_soft: torch.Tensor, update_threshold: float = 0.5) -> torch.Tensor:
    """Local-maximum filter over soft decisions along time (``tggcn/nn/
    temporal.py:17``): a frame commits where its soft value exceeds both
    neighbours' (zero outside the clip) and reaches the threshold.

    Arguments:
        u_soft - (B, T, ...) soft decisions, time on axis 1.
    Returns:
        Filtered hard decisions (same shape). The gradient passes through
        the straight-through term at the local maxima and where that term
        is <= 0 (every frame below the threshold); it is zero elsewhere.
        The expression order is JAX's, so the values are its bits.
    """
    zeros = torch.zeros_like(u_soft[:, :1])
    prev = torch.cat([zeros, u_soft[:, :-1]], dim=1)
    nxt = torch.cat([u_soft[:, 1:], zeros], dim=1)
    condition = (u_soft > prev) & (u_soft > nxt) & (u_soft >= update_threshold)
    hard = (u_soft >= update_threshold).to(u_soft.dtype)
    hard_ste = u_soft + (hard - u_soft).detach()
    clamped = torch.where(hard_ste <= 0.0, hard_ste, torch.zeros_like(hard_ste))
    return torch.where(condition, hard_ste, clamped)


def make_periodic_embedding(x: torch.Tensor, hidden_size: int) -> torch.Tensor:
    """Sin/cos positional embedding of a (*, 1) tensor -> (*, hidden_size)."""
    if hidden_size % 2:
        raise ValueError("hidden_size must be even.")
    exponent = torch.linspace(0.0, 1.0, hidden_size // 2, dtype=x.dtype, device=x.device)
    w = torch.full((), 1e4, dtype=x.dtype, device=x.device) ** exponent
    return torch.cat([torch.sin(x / w), torch.cos(x / w)], dim=-1)


def assemble_time_tensor(steps_per_example: torch.Tensor, max_num_steps: int,
                         ignore_division_by_num_steps: bool = False) -> torch.Tensor:
    """Time features (max_num_steps, batch, 1): frame t (from 1) over the
    clip's number of steps, or t itself."""
    x_time = torch.arange(1, max_num_steps + 1, dtype=steps_per_example.dtype,
                          device=steps_per_example.device)[:, None]
    x_time = x_time.expand(max_num_steps, steps_per_example.shape[0])
    if not ignore_division_by_num_steps:
        x_time = x_time / steps_per_example
    return x_time[..., None]


def assemble_segment_length_tensor(u_hard: torch.Tensor, steps_per_example: torch.Tensor,
                                   ignore_division_by_number_of_steps: bool = False
                                   ) -> torch.Tensor:
    """Per-frame relative segment length (B, T, E, 1): at each end frame
    (u != 0) the time feature times u less its value at the previous end
    frame; u times the time feature elsewhere (0 where u is 0).

    JAX runs this as a scan over time with an accumulator that restarts at
    each end frame and sums u x over the frames since (``tggcn/nn/
    temporal.py:78``). Here the value at the previous end frame is
    gathered, which equals the scan's accumulator bit for bit (adding a
    difference back to a smaller non-negative value gives the larger), and
    the accumulator's gradient, which also reaches the frames between two
    ends, rides on a term that is exactly zero in the forward.
    """
    b, t, _ = u_hard.shape
    x_time = assemble_time_tensor(steps_per_example, t,
                                  ignore_division_by_number_of_steps)[..., 0].T   # (B, T)
    v = u_hard * x_time[:, :, None]                                                 # (B, T, E)
    steps = torch.arange(t, device=u_hard.device)[None, :, None]
    ends = torch.where(v != 0, steps, -1)
    last = torch.cummax(ends, dim=1).values                  # the last end frame at or before t
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    at_prev = torch.gather(v, 1, prev.clamp(min=0))
    at_prev = torch.where(prev >= 0, at_prev, torch.zeros_like(at_prev))
    # The gradient of the frames after the previous end frame: the sum of
    # v over (prev, t), zero in value since v is 0 there.
    sums = torch.cumsum(v, dim=1)
    since = sums - torch.where(prev >= 0, torch.gather(sums, 1, prev.clamp(min=0)),
                               torch.zeros_like(sums)) - v
    acc = at_prev + (since - since.detach())
    return torch.where(v != 0, v - acc, v)[..., None]
