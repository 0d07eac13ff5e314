"""Build the CUDA sources under ``tggcn_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and builds with one
``nvcc`` process into ``tggcn_torch/_build/<name>-<hash>.so`` (the directory
is git-ignored). The processes of all sources start together, so a build
takes as long as the slowest file: seconds, since no source includes
PyTorch's headers. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags: a library is rebuilt only when one of them
changes. Nothing builds on import; the first kernel launch (or ``build()``)
does.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("gru_sequence", "gru_sequence_bwd", "segment_scan", "segment_scan_bwd", "geo_gcn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels of tggcn_torch cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES, timeout: float = BUILD_TIMEOUT_S) -> dict:
    """Build the libraries that are missing; returns {name: seconds spent}.

    The compiler's report (registers, shared memory, spills) of each build
    is kept beside the library as ``<name>-<hash>.log``.
    """
    missing = [n for n in names if not library_path(n).exists()]
    if not missing:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    procs = {}
    for name in missing:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failures = {}, []
    try:
        for name, (proc, tmp, out) in procs.items():
            remaining = max(1.0, timeout - (time.perf_counter() - start))
            log, _ = proc.communicate(timeout=remaining)
            seconds[name] = time.perf_counter() - start
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if a kernel wrapper is called, outside its autograd Function,
    on tensors that need a gradient: a kernel's output carries no autograd
    history, so the gradient would be dropped without a word."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{what} was called on tensors that require grad outside its "
            "autograd Function; call its differentiable entry point instead")


def count_launch(wrapper, io) -> None:
    """One more launch of wrapper's kernel of the IO dtype io: float32 in
    ``wrapper.launches``, bfloat16 in ``wrapper.launches_bf16``."""
    attr = "launches_bf16" if io == torch.bfloat16 else "launches"
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def upcast(x):
    """A plain version's working copy of x: float32 for bfloat16 IO, the
    tensor itself for any other dtype (float32, or float64 in gradchecks)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def rounding(io):
    """x -> x rounded to the IO dtype io and back, where a kernel rounds to
    it; the identity unless io is bfloat16."""
    if io != torch.bfloat16:
        return lambda x: x
    return lambda x: x.to(io).float()
