"""File / directory helpers (reference pyrutils/utils.py:9-31)."""

import os
import shutil
from typing import Dict


def cleanup_directory(dirpath: str) -> None:
    """Remove files and sub-directories of a directory without deleting it."""
    for filename in os.listdir(dirpath):
        filepath = os.path.join(dirpath, filename)
        try:
            if os.path.isfile(filepath) or os.path.islink(filepath):
                os.unlink(filepath)
            elif os.path.isdir(filepath):
                shutil.rmtree(filepath)
        except Exception as e:  # noqa: BLE001 - best-effort cleanup, matches reference
            print(f"Failed to delete {filepath}. Reason: {e}")


def read_dictionary(filepath: str) -> Dict[str, str]:
    """Read a 'key value'-per-line text file into a dict."""
    d = {}
    with open(filepath, mode="r") as f:
        for line in f:
            k, v = line.strip().split(sep=" ")
            d[k] = v
    return d
