"""Checkpoints, the run-directory contract and warm starts (counterpart of
``tggcn/train/checkpoint.py``).

A run dir, ``outputs/<data.name>/<model>/<checkpoint_name>/``, holds the
frozen config under ``.hydra/config.yaml`` and ``<checkpoint_name>.ckpt``:
a pickle of {epoch, model_state_dict, losses, scalers, ...} whose
``model_state_dict`` is the JAX package's parameter tree as numpy arrays.
The port writes the same layout, so the JAX package's ``RunDir`` and
``load_model_weights`` read a port's run dir, and the port reads the JAX
package's. ``last.ckpt`` is the snapshot of a run in progress (replaced
atomically each epoch): the parameters, the port's own optimizer state
(``torch.optim.Adam.state_dict``), the epoch, the global step, the best
validation loss and the best checkpoint so far.

A reference ``.tar`` run dir (torch) is read through
``compat/weights.py``. ``checkpoint_backend=orbax`` is JAX's array store
and is not ported: reading or writing it raises.

Stage 2 starts from a stage-1 run's weights: ``merge_params`` is the
reference's non-strict ``load_state_dict(strict=False)`` over parameter
trees.
"""

import os
import pickle
from typing import Optional

import numpy as np
import torch

from tggcn_torch.compat.weights import (baseline_params_from_torch_state_dict,
                                        params_from_numpy, params_to_numpy,
                                        tggcn_params_from_torch_state_dict)
from tggcn_torch.data.loading import ScalerUnpickler, scaler_pickle
from tggcn_torch.models.tggcn import TGGCNConfig

ORBAX = ("checkpoint_backend=orbax stores the parameters in orbax, JAX's array "
         "checkpoint library, which the port does not have (ROADMAP.md: not ported)")


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return ScalerUnpickler(f).load()


def save_checkpoint(log_dir: str, checkpoint: dict, checkpoint_name: str) -> str:
    """Write ``<log_dir>/<checkpoint_name>.ckpt`` (reference
    train_utils.py:235-253); tensors become numpy arrays."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, checkpoint_name + ".ckpt")
    with open(path, "wb") as f:
        pickle.dump(params_to_numpy(checkpoint), f)
    print(f"log files written to {path}")
    return path


def load_checkpoint(path: str) -> dict:
    """A ``.ckpt`` of the port or of the JAX package."""
    checkpoint = _load_pickle(path)
    if "__orbax_model__" in checkpoint:
        raise NotImplementedError(f"{path}: {ORBAX}")
    return checkpoint


def save_last(log_dir: str, state: dict) -> str:
    """The snapshot of a run in progress, replaced atomically: a crash
    while writing never leaves a broken last.ckpt."""
    os.makedirs(log_dir, exist_ok=True)
    tmp = os.path.join(log_dir, "last.ckpt.tmp")
    path = os.path.join(log_dir, "last.ckpt")
    state = dict(state)
    optimizer = _host(state.pop("optimizer", None))
    with open(tmp, "wb") as f:
        pickle.dump({**params_to_numpy(state), "optimizer": optimizer}, f)
    os.replace(tmp, path)
    return path


def _host(tree):
    """An optimizer state_dict with its tensors on the host (kept as tensors)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def load_last(log_dir: str) -> Optional[dict]:
    """The port's last.ckpt of a run dir, or None; a JAX run's, which holds
    optax's state, raises (pickle.UnpicklingError)."""
    path = os.path.join(log_dir, "last.ckpt")
    if not os.path.exists(path):
        return None
    return _load_pickle(path)


def _run_files(model_dir: str):
    basename = os.path.basename(os.path.normpath(model_dir))
    return (os.path.join(model_dir, basename + ".ckpt"),
            os.path.join(model_dir, basename + ".tar"), basename)


def _load_tar(path: str) -> dict:
    # Reference .tar files also hold scikit-learn scalers, which torch's
    # weights_only loading refuses (they are the user's own run files);
    # ScalerUnpickler reads them as the port's StandardScaler.
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=scaler_pickle)


def load_run_checkpoint(model_dir: str) -> dict:
    """A run dir's whole checkpoint dict, ``<basename>.ckpt`` (port or JAX)
    or a reference ``<basename>.tar`` (its weights stay torch tensors)."""
    ckpt, tar, basename = _run_files(model_dir)
    if os.path.exists(ckpt):
        return load_checkpoint(ckpt)
    if os.path.exists(tar):
        return _load_tar(tar)
    raise FileNotFoundError(f"No checkpoint found in {model_dir} "
                            f"(looked for {basename}.ckpt and {basename}.tar)")


def load_model_weights(model_dir: str, cfg=None) -> dict:
    """A run dir's model parameters as the port's tree of CPU float32
    tensors (reference models.py:1630-1634). A reference ``.tar`` is
    converted by ``tggcn_params_from_torch_state_dict``, which needs the
    model's TGGCNConfig ``cfg``, or, for a baseline (``cfg`` None or a
    BaselineConfig, as JAX passes None), by
    ``baseline_params_from_torch_state_dict``."""
    ckpt, tar, basename = _run_files(model_dir)
    if os.path.exists(ckpt):
        return params_from_numpy(load_checkpoint(ckpt)["model_state_dict"])
    if os.path.exists(tar):
        sd = {k: np.asarray(v) for k, v in _load_tar(tar)["model_state_dict"].items()}
        if isinstance(cfg, TGGCNConfig):
            return tggcn_params_from_torch_state_dict(sd, cfg)
        return baseline_params_from_torch_state_dict(sd)
    raise FileNotFoundError(f"No checkpoint found in {model_dir} "
                            f"(looked for {basename}.ckpt and {basename}.tar)")


def merge_params(init_params, loaded):
    """init_params with every leaf that loaded has at the same path and
    with the same shape taken from loaded; the rest kept.

    A list (an MLP's layers) has no shape of its own and is taken whole
    from loaded, as the JAX package's merge_params takes it.
    """
    if not isinstance(init_params, dict) or not isinstance(loaded, dict):
        if getattr(init_params, "shape", None) == getattr(loaded, "shape", None):
            return loaded
        return init_params
    return {k: merge_params(v, loaded[k]) if k in loaded else v
            for k, v in init_params.items()}


def count_merged(init_params, merged) -> int:
    """The number of tensor leaves of merged that are not init_params's own."""
    if isinstance(merged, dict):
        return sum(count_merged(init_params.get(k) if isinstance(init_params, dict) else None, v)
                   for k, v in merged.items())
    if isinstance(merged, (list, tuple)):
        own = init_params if isinstance(init_params, (list, tuple)) else ()
        return sum(count_merged(own[i] if i < len(own) else None, v)
                   for i, v in enumerate(merged))
    return int(merged is not init_params)
