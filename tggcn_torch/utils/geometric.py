"""Numpy geometry utilities (bounding boxes, IoU, centroids).

Covers the capability surface of reference pyrutils/geometric.py:6-116 and the
centroid helper in vhoi/data_loading.py:985-995, reformulated around a single
box decomposition: a box ``(..., 4)`` is split into its low corner ``lo =
box[..., :2]`` and high corner ``hi = box[..., 2:]``; every operation below is
an elementwise min/max/clip on those corners. All functions are NaN-aware and
vectorised over arbitrary leading dimensions.
"""

from typing import List, Union

import numpy as np


def _corners(box: np.ndarray):
    """Split (..., 4) boxes into (lo, hi) corner arrays of shape (..., 2)."""
    return box[..., :2], box[..., 2:]


def _box(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Assemble (lo, hi) corner arrays back into (..., 4) boxes."""
    return np.concatenate([lo, hi], axis=-1)


def bounding_boxes_from_keypoints(keypoints: np.ndarray) -> np.ndarray:
    """Tightest box around keypoints: (..., K, 2) -> (..., 4), NaN points skipped."""
    return _box(np.nanmin(keypoints, axis=-2), np.nanmax(keypoints, axis=-2))


def alter_bounding_boxes_size(bounding_boxes: np.ndarray,
                              alter_percentage: Union[int, float]) -> np.ndarray:
    """Grow/shrink boxes about their centre.

    Each side length s becomes s * (2p - 1) for p = alter_percentage / 100
    (p > 1 grows, p < 1 shrinks; p = 0.5 collapses to the centre point), which
    is the closed form of the reference's two-branch add/subtract rule
    (pyrutils/geometric.py:20-45).
    """
    lo, hi = _corners(bounding_boxes)
    centre = (lo + hi) / 2
    half = (hi - lo) / 2 * (2 * alter_percentage / 100 - 1)
    return _box(centre - half, centre + half)


def intersect_bounding_boxes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection box of a and b; all-NaN where they are disjoint."""
    lo = np.maximum(a[..., :2], b[..., :2])
    hi = np.minimum(a[..., 2:], b[..., 2:])
    nonempty = np.all(hi >= lo, axis=-1, keepdims=True)
    return np.where(nonempty, _box(lo, hi), np.nan)


def unionize_bounding_boxes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Smallest box covering both a and b."""
    return _box(np.minimum(a[..., :2], b[..., :2]),
                np.maximum(a[..., 2:], b[..., 2:]))


def compute_bounding_boxes_area(bounding_boxes: np.ndarray) -> np.ndarray:
    """Area (..., 1) of boxes (..., 4)."""
    lo, hi = _corners(bounding_boxes)
    return np.prod(hi - lo, axis=-1, keepdims=True)


def iou_between_bounding_boxes(many_bounding_boxes: List[np.ndarray]) -> np.ndarray:
    """IoU (..., 1) of a list of box arrays.

    Intersection area is computed directly as the product of clipped side
    overlaps; the union is the covering box (matching the reference's
    definition at pyrutils/geometric.py:46-66, which uses the hull box —
    not inclusion-exclusion — as the denominator).
    """
    inter_lo, inter_hi = _corners(many_bounding_boxes[0])
    hull_lo, hull_hi = inter_lo, inter_hi
    for boxes in many_bounding_boxes[1:]:
        lo, hi = _corners(boxes)
        inter_lo, inter_hi = np.maximum(inter_lo, lo), np.minimum(inter_hi, hi)
        hull_lo, hull_hi = np.minimum(hull_lo, lo), np.maximum(hull_hi, hi)
    overlap = np.clip(inter_hi - inter_lo, 0.0, None)
    inter_area = np.prod(overlap, axis=-1, keepdims=True)
    inter_area = np.where(np.isnan(inter_area), 0.0, inter_area)
    hull_area = np.prod(hull_hi - hull_lo, axis=-1, keepdims=True)
    return inter_area / hull_area


def compute_centroid(bounding_boxes: np.ndarray) -> np.ndarray:
    """Centre points (..., 2) of boxes (..., 4)."""
    lo, hi = _corners(bounding_boxes)
    return (lo + hi) / 2
