"""Segment-state reordering (counterpart of ``tggcn/nn/temporal.py:36``)."""

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
