"""tggcn_torch — the PyTorch/CUDA port of tggcn for one NVIDIA H100.

The JAX package ``tggcn`` stays the reference; this package imports nothing
of it (nor JAX). Layout mirrors it:

    tggcn_torch.runtime  device choice (CUDA unless the caller asks for the
                         CPU) and float32 numerics with TF32 off
    tggcn_torch.nn       plain PyTorch layers (MLP, GRU, GeoGCN, messages)
    tggcn_torch.ops      hand-written CUDA kernels, their ctypes wrappers and
                         their plain PyTorch versions
    tggcn_torch.models   the 2G-GCN model (forward and training), the
                         baselines, sliding-window streaming and the model
                         registry
    tggcn_torch.train    losses, multi-task weighting, the train step, the
                         fit loop, checkpoints and run dirs, and the train
                         entry point (python -m tggcn_torch.train)
    tggcn_torch.parallel data-parallel training over processes
                         (torch.distributed: NCCL on the card, gloo on the
                         CPU) with the single-process step's results
    tggcn_torch.predict  the predict entry point (python -m tggcn_torch.predict)
    tggcn_torch.analysis the analysis entry point (python -m
                         tggcn_torch.analysis): F1 diffs and plots
    tggcn_torch.eval     run-dir discovery, batched inference, metrics
    tggcn_torch.data     dataset loading and assembly, synthetic datasets,
                         the batch feeders, fetchers and padding, the
                         CAD-120 video -> subject map (python -m
                         tggcn_torch.data.cross_validation)
    tggcn_torch.config   the conf/ YAML configs and overrides
    tggcn_torch.utils    numpy helpers (F1@k, run-length encoding, files),
                         keypoint and box drawing (cv2, imported when used)
    tggcn_torch.compat   weight bridges (JAX pytrees, reference state dicts)

Kernels build at first use (``tggcn_torch.ops._build``), never on import.
"""

__version__ = "0.1.0"
