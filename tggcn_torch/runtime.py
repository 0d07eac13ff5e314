"""Device choice and matmul numerics for the port.

Counterpart of ``tggcn/runtime.py``. The port's entry points run on the
CUDA card unless the caller asks for the CPU; asking for CUDA where there is
none raises instead of carrying on somewhere else. The float32 path is held
to tight tolerances against the JAX reference, and two reference fixtures
flip a hard segmentation decision under reduced-precision matmuls, so TF32
is pinned off for matmuls and cuDNN alike. The bfloat16 path's cuBLAS
products (input projections, embeddings and their backward) reduce in
float32, as XLA's do with ``preferred_element_type``: cuBLAS's reduced-
precision reduction for bfloat16 is pinned off too.
"""

import torch

# The configs' resources.parity_mode values. The JAX package switches its
# matmul precision by them; the port has one numerics mode
# (pin_float32_numerics) and runs either in it.
PARITY_MODES = ("fast", "exact")


def check_parity_mode(mode: str) -> None:
    if mode not in PARITY_MODES:
        raise ValueError(f"resources.parity_mode must be one of {PARITY_MODES}, not {mode!r}")


def pin_float32_numerics() -> None:
    """Full-precision float32 matmuls and convolutions (TF32 off), and
    bfloat16 matmuls that reduce in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says otherwise.

    Raises RuntimeError when CUDA is asked for (explicitly or by default) and
    no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tggcn_torch runs on 'cuda' or 'cpu', not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tggcn_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path.")
    pin_float32_numerics()
    return dev
