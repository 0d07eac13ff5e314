"""Segmentation metrics (F1@k) — parity with reference pyrutils/metrics.py:7-81.

The per-example scoring is a greedy TP assignment over predicted segments:
for each predicted segment (in temporal order), compute IoU against every
ground-truth segment, zero the IoU for class mismatches, take the argmax, and
count a true positive if IoU >= overlap and the GT segment is unused; else a
false positive. Unused GT segments are false negatives. Predicted segments with
class id >= num_classes are ignored.
"""

import numpy as np

from tggcn_torch.utils.itertools import rle_numpy


def f1_at_k_single_example(y_true, y_pred, num_classes: int, *, overlap: float) -> float:
    """F1@k between a single target and a single predicted segmentation.

    Reference semantics: pyrutils/metrics.py:7-61. Segment extraction is the
    RLE of consecutive identical labels; segment intervals are [start, end)
    index pairs.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    target_ids, t_starts, t_ends = rle_numpy(y_true)
    output_ids, o_starts, o_ends = rle_numpy(y_pred)

    true_positives = 0.0
    false_positives = 0.0
    used = np.zeros(len(target_ids), dtype=bool)
    for o_id, o_start, o_end in zip(output_ids, o_starts, o_ends):
        intersection = np.minimum(o_end, t_ends) - np.maximum(o_start, t_starts)
        union = np.maximum(o_end, t_ends) - np.minimum(o_start, t_starts)
        iou = (intersection / union) * (o_id == target_ids)
        idx = int(np.argmax(iou))
        if o_id >= num_classes:
            continue
        if iou[idx] >= overlap and not used[idx]:
            true_positives += 1
            used[idx] = True
        else:
            false_positives += 1
    false_negatives = len(used) - float(np.sum(used))
    denom_p = true_positives + false_positives
    precision = true_positives / denom_p if denom_p else 0.0
    denom_r = true_positives + false_negatives
    recall = true_positives / denom_r if denom_r else 0.0
    denom_f = precision + recall
    f1 = 2 * (precision * recall) / denom_f if denom_f else 0.0
    return f1


def f1_at_k(y_true, y_pred, num_classes: int, *, overlap: float, ignore_value: float = None) -> float:
    """Batched F1@k with padding removal (reference pyrutils/metrics.py:64-81).

    Frames whose target equals ignore_value are dropped before segment
    extraction; examples whose targets are all padding do not contribute.
    """
    f1 = 0.0
    effective_examples = 0.0
    for y_t, y_p in zip(y_true, y_pred):
        y_t, y_p = np.asarray(y_t), np.asarray(y_p)
        if ignore_value is not None:
            indices = y_t != ignore_value
            y_t, y_p = y_t[indices], y_p[indices]
        if y_t.size == 0:
            continue
        f1 += f1_at_k_single_example(y_t, y_p, num_classes, overlap=overlap)
        effective_examples += 1
    return f1 / effective_examples
