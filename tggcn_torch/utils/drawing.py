"""Keypoint / skeleton overlays on images (counterpart of
``tggcn/utils/drawing.py``, reference pyrutils/cv2.py:5-57).

cv2 is an optional dependency (absent in minimal installs); functions raise a
clear ImportError when it is missing.
"""

from typing import Optional, Sequence, Tuple

import numpy as np


def _require_cv2():
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - depends on environment
        raise ImportError("Keypoint drawing requires opencv-python (cv2).") from e
    return cv2


def draw_keypoints(image: np.ndarray, keypoints: np.ndarray,
                   connections: Optional[Sequence[Tuple[int, int]]] = None,
                   color: Tuple[int, int, int] = (0, 255, 0), radius: int = 3,
                   thickness: int = 2, dotted: bool = False) -> np.ndarray:
    """Draw keypoints (K, 2) and optional skeleton connections onto an image.

    NaN keypoints are skipped. Returns the annotated image (copy).
    """
    cv2 = _require_cv2()
    image = image.copy()
    keypoints = np.asarray(keypoints)
    for x, y in keypoints:
        if np.isnan(x) or np.isnan(y):
            continue
        cv2.circle(image, (int(round(x)), int(round(y))), radius, color, -1)
    for a, b in connections or []:
        pa, pb = keypoints[a], keypoints[b]
        if np.isnan(pa).any() or np.isnan(pb).any():
            continue
        pa = (int(round(pa[0])), int(round(pa[1])))
        pb = (int(round(pb[0])), int(round(pb[1])))
        if dotted:
            _dotted_line(cv2, image, pa, pb, color, thickness)
        else:
            cv2.line(image, pa, pb, color, thickness)
    return image


def _dotted_line(cv2, image, pt1, pt2, color, thickness, gap: int = 7):
    dist = float(np.hypot(pt2[0] - pt1[0], pt2[1] - pt1[1]))
    num = max(int(dist / gap), 1)
    for i in range(num + 1):
        r = i / num
        x = int(round(pt1[0] * (1 - r) + pt2[0] * r))
        y = int(round(pt1[1] * (1 - r) + pt2[1] * r))
        cv2.circle(image, (x, y), thickness // 2 + 1, color, -1)


def draw_bounding_boxes(image: np.ndarray, boxes: np.ndarray,
                        color: Tuple[int, int, int] = (255, 0, 0),
                        thickness: int = 2) -> np.ndarray:
    """Draw (N, 4) x_min,y_min,x_max,y_max boxes; NaN boxes skipped."""
    cv2 = _require_cv2()
    image = image.copy()
    for box in np.asarray(boxes).reshape(-1, 4):
        if np.isnan(box).any():
            continue
        x0, y0, x1, y1 = (int(round(v)) for v in box)
        cv2.rectangle(image, (x0, y0), (x1, y1), color, thickness)
    return image
