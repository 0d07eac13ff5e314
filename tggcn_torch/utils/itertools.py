"""Iteration helpers (run-length encoding and friends).

Behavioural parity with the reference's pyrutils/itertools.py:5-18 and
pyrutils/utils.py:33-42, re-expressed with numpy-friendly fast paths.
"""

from itertools import groupby
from typing import Iterable, Iterator, Tuple

import numpy as np


def negative_range(n: int) -> range:
    """Range iterating through -1, -2, ..., -n (reference pyrutils/itertools.py:5)."""
    if n < 1:
        raise ValueError(f"negative_range needs n >= 1, got {n}.")
    return range(-1, -n - 1, -1)


def run_length_encoding(iterable: Iterable) -> Iterator[Tuple[object, int]]:
    """Yield (label, run_length) pairs (reference pyrutils/itertools.py:15)."""
    for k, v in groupby(iterable):
        yield k, len(list(v))


def run_length_encoding_intervals(iterable: Iterable) -> Iterator[Tuple[int, int]]:
    """Yield (start_incl, end_excl) index pairs of each run (reference pyrutils/utils.py:33)."""
    lengths = [length for _, length in run_length_encoding(iterable)]
    starts = np.concatenate([[0], np.cumsum(lengths)])
    return zip(starts[:-1].tolist(), starts[1:].tolist())


def rle_numpy(labels: np.ndarray):
    """Vectorised run-length encoding of a 1-D label array.

    Returns:
        (ids, starts, ends) — per-run label id, start index (incl.) and end index (excl.).
    """
    labels = np.asarray(labels)
    if labels.size == 0:
        return labels[:0], np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    change = np.nonzero(labels[1:] != labels[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [labels.size]])
    return labels[starts], starts, ends
