"""Sliding-window streaming inference for long untrimmed videos.

Counterpart of ``tggcn/models/streaming.py``. A stream (B, T, ...) is
served in chunks of ``window`` frames to emit plus up to ``lookahead``
frames of future context:

  * exact forward recurrence: the forward frame BiGRUs (K1's forward
    streams) and the forward segment scan (K3, or K5 in its other modes,
    or the general scan) start each chunk from the states the previous
    chunk reached at its last emitted frame (``apply_tggcn``'s ``carry``),
    so lookahead frames never leak into the next chunk's state;
  * bounded lookahead for the backward direction: the backward GRUs and
    the reorder see ``lookahead`` frames of future context, approximating
    the offline bidirectional model with O(window + lookahead) latency and
    memory; with a lookahead that reaches the stream's end the streamed
    outputs equal the offline forward;
  * chunks are not padded (pad frames would corrupt the backward carry):
    the final chunk is shorter, and only the chunk that holds the stream's
    last frame applies the forced final commit;
  * ``gs`` decisions need ``gs_noise='frame_indexed'``: each absolute
    frame then draws the same noise in any window (the frame offset is
    threaded through the carry).

``fuse_group`` keeps JAX's meaning, the number of interior windows between
host copies: ``run`` copies the stream to the card one group of windows at
a time and runs the group's windows back to back on the stream, with no
host sync inside a group; every emitted output stays on the card until one
copy to the host at the end. ``fuse_directions`` has no counterpart: the
port has one route (K1 runs both directions of every stream in one launch,
K3/K5 both directions of the scan); it is accepted and changes nothing.
Serving runs under ``torch.no_grad()``; ``use_kernels=False`` runs the
kernels' plain versions (the reference route).
"""

from typing import Optional

import numpy as np
import torch

from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn, check_slice
from tggcn_torch.nn.distributions import GUMBEL_STRATEGIES


def _first_device(tree) -> torch.device:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def _keep(outputs, emit: int) -> list:
    """The first `emit` frames of each output: class outputs are (B, C, T,
    E), decision outputs (B, T, E)."""
    return [o[:, :, :emit] if o.ndim == 4 else o[:, :emit] for o in outputs]


class StreamingRunner:
    def __init__(self, params: dict, cfg: TGGCNConfig, window: int, lookahead: int,
                 seed: int = 42, fuse_group: int = 16, fuse_directions: Optional[bool] = None,
                 allow_reference_geometry: bool = False, use_kernels: bool = True):
        if cfg.geometry_flatten != "per_frame" and not allow_reference_geometry:
            # The reference geometry reshape mixes the time axis into the
            # feature axis, so a window's geometry features depend on the
            # chunk length and windowed inference diverges from offline.
            raise ValueError(
                "StreamingRunner requires geometry_flatten='per_frame': the "
                "'reference' flatten couples geometry features to the clip "
                "length, which windowing changes. Pass "
                "allow_reference_geometry=True to accept the approximation.")
        if (cfg.discrete_optimization_strategy in GUMBEL_STRATEGIES
                and cfg.gs_noise != "frame_indexed"):
            # Batched noise is drawn over the whole window, so an absolute
            # frame resamples different noise depending on where a window starts.
            raise ValueError(
                "StreamingRunner with gs decisions requires "
                "gs_noise='frame_indexed' (window-independent noise). "
                "Rebuild the config with gs_noise='frame_indexed', or serve "
                "with discrete_optimization_strategy='st'.")
        check_slice(cfg)
        self.params, self.cfg = params, cfg
        self.window, self.lookahead = window, lookahead
        self.fuse_group = max(1, int(fuse_group))
        self.fuse_directions = fuse_directions          # inert: see the module's docstring
        self.seed, self.use_kernels = seed, use_kernels
        self.device = _first_device(params)

    def _to_device(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32).to(self.device, non_blocking=True)

    @torch.no_grad()
    def _forward(self, x_human, x_objects, objects_mask, carry, human_segmentation,
                 frame_offset, is_last):
        """One chunk on the card: (outputs, the forward states of every step)."""
        b, chunk = x_human.shape[:2]
        outputs, aux = apply_tggcn(
            self.params, self.cfg, x_human, x_objects, objects_mask,
            human_segmentation=human_segmentation,
            steps_per_example=torch.full((b,), float(chunk), device=self.device),
            train=False, use_kernels=self.use_kernels,
            generator=torch.Generator(device=self.device).manual_seed(self.seed),
            carry=carry or None, return_carry=True, force_last_step_commit=is_last,
            frame_offset=frame_offset)
        return outputs, aux["carry_seq"]

    def process_window(self, x_human, x_objects, objects_mask, carry=None,
                       human_segmentation=None, is_last: bool = False,
                       frame_offset: Optional[int] = None):
        """Process ONE chunk step-wise (the caller owns the loop as frames
        arrive): x_human (B, W+L, ...) holds ``window`` frames to emit and up
        to ``lookahead`` frames of context (fewer only at the stream's end,
        with is_last=True, which also applies the forced final commit).
        Returns (outputs over the whole chunk, of which the caller keeps the
        first min(window, chunk) frames; the carry for the next call, on the
        card). The carry tracks the stream's absolute frame, so
        frame-indexed noise matches the offline pass without the caller
        counting frames; an explicit frame_offset overrides it."""
        b, chunk = x_human.shape[:2]
        carry = dict(carry) if carry else {}
        tracked_offset = carry.pop("frame_offset", 0)
        if frame_offset is None:
            frame_offset = int(tracked_offset)
        outputs, carry_seq = self._forward(
            self._to_device(x_human), self._to_device(x_objects), self._to_device(objects_mask),
            carry, self._to_device(human_segmentation), frame_offset, is_last)
        boundary = min(self.window, chunk) - 1
        carry = {k: v[:, boundary] for k, v in carry_seq.items()}
        carry["frame_offset"] = frame_offset + boundary + 1
        return outputs, carry

    def run(self, x_human, x_objects, objects_mask, human_segmentation=None) -> list:
        """Serve a (B, T, ...) stream window by window; returns the outputs
        of ``apply_tggcn``'s layout, each stitched along time to the full T,
        as numpy arrays."""
        b, t = x_human.shape[:2]
        chunk_len = self.window + self.lookahead
        starts_all = list(range(0, t, self.window))
        # Interior windows (a full chunk that does not reach the stream's
        # end) go in groups; the rest one by one (short chunks, is_last).
        interior = [s for s in starts_all if s + chunk_len < t]
        groups = [interior[g:g + self.fuse_group] for g in range(0, len(interior),
                                                                  self.fuse_group)]
        groups += [[s] for s in starts_all[len(interior):]]
        mask = self._to_device(objects_mask)
        emitted, carry = [], {}
        for group in groups:
            lo, hi = group[0], min(group[-1] + chunk_len, t)
            xh, xo = self._to_device(x_human[:, lo:hi]), self._to_device(x_objects[:, lo:hi])
            seg = (None if human_segmentation is None
                   else self._to_device(human_segmentation[:, lo:hi]))
            for start in group:
                end = min(start + chunk_len, t)
                part = slice(start - lo, end - lo)
                outputs, carry_seq = self._forward(
                    xh[:, part], xo[:, part], mask, carry,
                    None if seg is None else seg[:, part], start, end == t)
                emit = min(self.window, t - start)
                emitted.append(_keep(outputs, emit))
                carry = {k: v[:, emit - 1] for k, v in carry_seq.items()}
        return [torch.cat(parts, dim=2 if parts[0].ndim == 4 else 1).cpu().numpy()
                for parts in zip(*emitted)]
