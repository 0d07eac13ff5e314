"""Segmentation-target assembly (counterpart of ``tggcn/data/assembly.py:
79-102``): the end-of-segment flags a loader turns into the targets of the
segmentation loss.

With a positive sigma, as stage 2 trains (``conf/models/2G-GCN_stage2.yaml``
``segmentation_loss.sigma``), the last end flag of each entity is dropped
and the flags are smoothed by a Gaussian over time; -1 marks padding and
stays -1 (``assemble_segmentation_targets``, as ``assemble_mphoi_tensors``
applies them, ``tggcn/data/assembly.py:550-552``). The functions return new
arrays and leave their inputs as they were.
"""

import numpy as np
from scipy.ndimage import gaussian_filter1d


def ignore_last_step_end_flag(x: np.ndarray) -> np.ndarray:
    """(N, T) end flags with the final end flag of each example set to 0."""
    x = np.array(x)
    has_end = (x == 1.0).any(axis=1)
    last_end = x.shape[1] - 1 - np.argmax((x == 1.0)[:, ::-1], axis=1)
    rows = np.nonzero(has_end)[0]
    x[rows, last_end[rows]] = 0.0
    return x


def ignore_last_step_end_flag_general(x: np.ndarray) -> np.ndarray:
    """ignore_last_step_end_flag for each entity of (N, T, E) end flags."""
    x = np.array(x)
    for e in range(x.shape[-1]):
        x[:, :, e] = ignore_last_step_end_flag(x[:, :, e])
    return x


def smooth_segmentation(x: np.ndarray, sigma: float) -> np.ndarray:
    """End flags (N, T, ...) smoothed over time by a Gaussian of width
    sigma (zero beyond the clip), scaled by 2.5 sigma and clipped to [0, 1];
    -1 padding kept. sigma 0 returns the flags unchanged."""
    x = np.array(x)
    if sigma:
        missing = x == -1.0
        x[missing] = 0.0
        x = np.clip(gaussian_filter1d(x, sigma=sigma, axis=1, mode="constant") * 2.5 * sigma,
                    0.0, 1.0)
        x[missing] = -1.0
    return x


def assemble_segmentation_targets(flags: np.ndarray, sigma: float) -> np.ndarray:
    """The targets of the segmentation loss from (N, T, E) end flags."""
    if sigma:
        flags = ignore_last_step_end_flag_general(flags)
    return smooth_segmentation(flags, sigma)
