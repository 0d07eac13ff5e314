"""ctypes bindings for the native metric kernels (native/fast_metrics.cpp).

Falls back transparently to the numpy implementation when the shared library
has not been built (``make -C native``).
"""

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libfastmetrics.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.f1_at_k_single.restype = ctypes.c_double
    lib.f1_at_k_single.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_double]
    lib.f1_at_k_batch.restype = ctypes.c_double
    lib.f1_at_k_batch.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_double, ctypes.c_int64]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def f1_at_k_single_example(y_true, y_pred, num_classes: int, *, overlap: float) -> float:
    lib = _load()
    y_true = np.ascontiguousarray(np.asarray(y_true), dtype=np.int64)
    y_pred = np.ascontiguousarray(np.asarray(y_pred), dtype=np.int64)
    if lib is None:
        from tggcn_torch.utils import metrics

        return metrics.f1_at_k_single_example(y_true, y_pred, num_classes,
                                              overlap=overlap)
    return lib.f1_at_k_single(y_true, y_pred, len(y_true), num_classes, overlap)


def f1_at_k(y_true, y_pred, num_classes: int, *, overlap: float,
            ignore_value: Optional[float] = None) -> float:
    lib = _load()
    y_true = np.ascontiguousarray(np.asarray(y_true), dtype=np.int64)
    y_pred = np.ascontiguousarray(np.asarray(y_pred), dtype=np.int64)
    if lib is None or y_true.ndim != 2:
        from tggcn_torch.utils import metrics

        return metrics.f1_at_k(y_true, y_pred, num_classes, overlap=overlap,
                               ignore_value=ignore_value)
    ignore = int(ignore_value) if ignore_value is not None else np.iinfo(np.int64).min
    return lib.f1_at_k_batch(y_true, y_pred, y_true.shape[0], y_true.shape[1],
                             num_classes, overlap, ignore)
