"""Vendored read/write support for zarr-v2 DirectoryStores.

The reference distributes its datasets as zarr 2.4 DirectoryStores
(vhoi/data_loading.py:27-31, 66-75, 121-127) and its feature extractor writes
them (vhoi/roi_features.py:206-207, 278-279). The zarr package is not a
dependency here; the v2 on-disk format is small enough to support directly:

  * group  = directory containing a ``.zgroup`` JSON ({"zarr_format": 2})
  * array  = directory containing a ``.zarray`` JSON (shape/chunks/dtype/
    compressor/fill_value/order/filters) plus one file per chunk, named by
    its grid index joined with the dimension separator ('.' by default)

Read path decompression:
  * ``null`` compressor and numcodecs zlib/gzip — pure Python (stdlib)
  * blosc (zarr's default, cname lz4) — native decoder in
    native/bloscdec.cpp via ctypes

Write path always uses ``compressor: null`` so produced stores are readable
by any zarr implementation with no codec dependencies.
"""

import ctypes
import itertools
import json
import os
import zlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libbloscdec.so")
_lib = None


def _load_native():
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.blosc_lz4_decompress.restype = ctypes.c_long
        lib.blosc_lz4_decompress.argtypes = [u8p, ctypes.c_long, u8p,
                                             ctypes.c_long]
        _lib = lib
    return _lib


def _decompress_blosc(payload: bytes, nbytes_hint: int) -> bytes:
    lib = _load_native()
    if lib is None:
        raise RuntimeError(
            "blosc-compressed zarr chunk found but native/libbloscdec.so is "
            "not built; run `make -C native`.")
    src = np.frombuffer(payload, dtype=np.uint8)
    dst = np.empty(nbytes_hint, dtype=np.uint8)
    n = lib.blosc_lz4_decompress(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst.size)
    if n < 0:
        detail = {-3: "non-LZ4 codec"}.get(n, "malformed")
        raise ValueError(f"cannot decode blosc chunk ({detail}, code {n})")
    return dst[:n].tobytes()


def _decompress(payload: bytes, compressor: Optional[dict],
                nbytes: int) -> bytes:
    if compressor is None:
        return payload
    codec = compressor.get("id")
    if codec == "blosc":
        return _decompress_blosc(payload, nbytes)
    if codec == "zlib":
        return zlib.decompress(payload)
    if codec == "gzip":
        import gzip

        return gzip.decompress(payload)
    raise ValueError(f"unsupported zarr compressor {codec!r}")


class Array:
    """Read-only zarr-v2 array; materialises to numpy on first indexing."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{path}: not a zarr-v2 array")
        if meta.get("filters"):
            raise ValueError(f"{path}: zarr filters are not supported")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        self.fill_value = meta.get("fill_value", 0)
        self.compressor = meta.get("compressor")
        self.separator = meta.get("dimension_separator", ".")
        self._cache = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 0

    def _materialise(self) -> np.ndarray:
        if self._cache is not None:
            return self._cache
        fill = 0 if self.fill_value is None else self.fill_value
        out = np.full(self.shape, fill, dtype=self.dtype)
        if out.size:
            grid = [range((dim + chunk - 1) // chunk)
                    for dim, chunk in zip(self.shape, self.chunks)]
            nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
            for index in itertools.product(*grid):
                name = self.separator.join(str(i) for i in index) or "0"
                chunk_path = os.path.join(self.path, name)
                if not os.path.exists(chunk_path):
                    continue  # missing chunk stays at fill_value
                with open(chunk_path, "rb") as f:
                    raw = _decompress(f.read(), self.compressor, nbytes)
                block = np.frombuffer(raw, dtype=self.dtype)
                block = block.reshape(self.chunks, order=self.order)
                window = tuple(
                    slice(i * c, min((i + 1) * c, dim))
                    for i, c, dim in zip(index, self.chunks, self.shape))
                trim = tuple(slice(0, w.stop - w.start) for w in window)
                out[window] = block[trim]
        self._cache = out
        return out

    def __getitem__(self, item):
        return self._materialise()[item]

    def __array__(self, dtype=None):
        data = self._materialise()
        return data.astype(dtype) if dtype is not None else data


class Group:
    """Read-only zarr-v2 group over a directory tree."""

    def __init__(self, path: str):
        self.path = path

    def __getitem__(self, key: str) -> Union["Group", Array]:
        target = os.path.join(self.path, *str(key).split("/"))
        if os.path.exists(os.path.join(target, ".zarray")):
            return Array(target)
        if os.path.exists(os.path.join(target, ".zgroup")):
            return Group(target)
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def keys(self):
        for name in sorted(os.listdir(self.path)):
            member = os.path.join(self.path, name)
            if (os.path.exists(os.path.join(member, ".zarray")) or
                    os.path.exists(os.path.join(member, ".zgroup"))):
                yield name

    def __iter__(self):
        return self.keys()


def open_readonly(path: str) -> Union[Group, Array]:
    """Open a zarr-v2 DirectoryStore root (group or bare array)."""
    if os.path.exists(os.path.join(path, ".zarray")):
        return Array(path)
    if os.path.exists(os.path.join(path, ".zgroup")):
        return Group(path)
    raise FileNotFoundError(
        f"{path}: no .zgroup/.zarray found (not a zarr-v2 DirectoryStore)")


# --------------------------------------------------------------------------
# Write path (compressor: null — universally readable)
# --------------------------------------------------------------------------


def create_group(path: str) -> str:
    """Create (or reuse) a zarr-v2 group directory; returns its path."""
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, ".zgroup")
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            json.dump({"zarr_format": 2}, f)
    return path


def write_array(group_path: str, name: str, data: np.ndarray,
                chunks: Optional[Sequence[int]] = None) -> str:
    """Write `data` as an uncompressed zarr-v2 array under a group."""
    data = np.ascontiguousarray(data)
    if chunks is None:
        chunks = _default_chunks(data.shape, data.dtype.itemsize)
    chunks = tuple(int(c) for c in chunks)
    array_path = os.path.join(group_path, *name.split("/"))
    parent = os.path.dirname(array_path)
    if parent != group_path and parent.startswith(group_path):
        # Intermediate names become sub-groups so real zarr can navigate.
        sub = group_path
        for part in os.path.relpath(parent, group_path).split(os.sep):
            sub = create_group(os.path.join(sub, part))
    os.makedirs(array_path, exist_ok=True)
    fill_value: Union[int, float] = 0
    if np.issubdtype(data.dtype, np.floating):
        fill_value = 0.0
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "compressor": None,
        "fill_value": fill_value,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(array_path, ".zarray"), "w") as f:
        json.dump(meta, f)
    grid = [range((dim + chunk - 1) // chunk)
            for dim, chunk in zip(data.shape, chunks)]
    for index in itertools.product(*grid):
        window = tuple(slice(i * c, min((i + 1) * c, dim))
                       for i, c, dim in zip(index, chunks, data.shape))
        block = np.zeros(chunks, dtype=data.dtype)
        piece = data[window]
        block[tuple(slice(0, s) for s in piece.shape)] = piece
        chunk_name = ".".join(str(i) for i in index) or "0"
        with open(os.path.join(array_path, chunk_name), "wb") as f:
            f.write(block.tobytes(order="C"))
    return array_path


def _default_chunks(shape: Tuple[int, ...], itemsize: int,
                    target_bytes: int = 1 << 22) -> Tuple[int, ...]:
    """Chunk the leading axis so chunks stay near target_bytes (<= shape)."""
    if not shape:
        return ()
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize
    lead = max(1, min(shape[0], target_bytes // max(row_bytes, 1)))
    return (int(lead),) + tuple(int(s) for s in shape[1:])
