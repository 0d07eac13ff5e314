"""Numpy helpers of the entry points: files, run-length encoding, F1@k
(in numpy, or native/libfastmetrics.so where it is built) and box
geometry."""
