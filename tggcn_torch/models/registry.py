"""Model registry: name -> (config, init, apply) on a device.

Counterpart of ``tggcn/models/registry.py:64-69``. ``init(generator)`` makes
random parameters; ``apply(params, train=..., generator=..., noise=...,
**batch)`` runs the forward on the model's device, moving numpy or tensor
inputs there. The device is CUDA
unless the caller passes ``device="cpu"``.
"""

from dataclasses import dataclass
from typing import Any, Callable

import torch

from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn, check_slice, init_tggcn
from tggcn_torch.runtime import resolve_device

_BATCH_TENSORS = ("x_human", "x_objects", "objects_mask", "human_segmentation",
                  "objects_segmentation", "human_human_distances",
                  "human_object_distances", "object_object_distances",
                  "steps_per_example")


@dataclass(frozen=True)
class ModelDef:
    name: str
    config: Any
    device: torch.device
    init: Callable
    apply: Callable


def select_model(model_name: str, device=None, **model_kwargs) -> ModelDef:
    if model_name != "2G-GCN":
        raise NotImplementedError(
            f"model {model_name!r}: tggcn_torch serves '2G-GCN' only")
    dev = resolve_device(device)
    cfg = TGGCNConfig.from_kwargs(**model_kwargs)
    check_slice(cfg)

    def init(generator: torch.Generator) -> dict:
        params = init_tggcn(generator, cfg)
        return to_device(params, dev)

    def apply(params, train: bool = False, generator=None, noise=None, **batch):
        """Serving (train=False) runs under torch.no_grad(); training keeps
        the autograd graph and returns the new BatchNorm state in aux."""
        batch = {k: (None if v is None else
                     torch.as_tensor(v, dtype=torch.float32, device=dev))
                 if k in _BATCH_TENSORS else v
                 for k, v in batch.items()}
        if noise is not None:
            noise = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for k, v in noise.items() if v is not None}
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return apply_tggcn(params, cfg, train=train, generator=generator, noise=noise,
                               **batch)

    return ModelDef(model_name, cfg, dev, init, apply)


def to_device(tree, device):
    """A tree of dicts and lists of tensors with every tensor on device."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
