"""Model registry: name -> (config, init, apply) on a device.

Counterpart of ``tggcn/models/registry.py``: the 2G-GCN and the two
baselines. ``init(generator)`` makes random parameters; ``apply(params,
train=..., generator=..., noise=..., **batch)`` runs the forward on the
model's device, moving numpy or tensor inputs there, and returns (outputs,
aux). The device is CUDA unless the caller passes ``device="cpu"``.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tggcn_torch.models.baselines import BASELINES, BaselineConfig, apply_baseline, init_baseline
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


def _as_batch(batch: dict, dev) -> dict:
    return {k: (None if v is None else torch.as_tensor(v, dtype=torch.float32, device=dev))
            if k in _BATCH_TENSORS else v for k, v in batch.items()}


def _tggcn_model(name: str, cfg: TGGCNConfig, dev) -> ModelDef:
    check_slice(cfg)

    def init(generator: torch.Generator) -> dict:
        return to_device(init_tggcn(generator, cfg), dev)

    def apply(params, train: bool = False, generator=None, noise=None, **batch):
        """Serving (train=False) runs under torch.no_grad(); training keeps
        the autograd graph and returns the new BatchNorm state in aux."""
        batch = _as_batch(batch, dev)
        if noise is not None:
            noise = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for k, v in noise.items() if v is not None}
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return apply_tggcn(params, cfg, train=train, generator=generator, noise=noise,
                               **batch)

    return ModelDef(name, cfg, dev, init, apply)


def _baseline_model(name: str, cfg: BaselineConfig, dev) -> ModelDef:
    def init(generator: torch.Generator) -> dict:
        return to_device(init_baseline(generator, cfg), dev)

    def apply(params, train: bool = False, use_kernels: bool = True, **batch):
        """(outputs, {'bn_state': None}), as JAX's baseline apply; the
        2G-GCN's other keywords (generator, noise, inspect_model) are
        taken and ignored."""
        batch = _as_batch(batch, dev)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            outputs = apply_baseline(params, cfg, batch["x_human"], batch["x_objects"],
                                     batch["objects_mask"], use_kernels=use_kernels)
        return outputs, {"bn_state": None}

    return ModelDef(name, cfg, dev, init, apply)


def select_model(model_name: str, device=None, **model_kwargs) -> ModelDef:
    dev = resolve_device(device)
    if model_name == "2G-GCN":
        return _tggcn_model(model_name, TGGCNConfig.from_kwargs(**model_kwargs), dev)
    if model_name in BASELINES:
        cfg = BaselineConfig.from_kwargs(with_object_head=model_name == "cad120_baseline",
                                         **model_kwargs)
        return _baseline_model(model_name, cfg, dev)
    raise ValueError(f"Unknown model {model_name}")


def with_config_changes(model: ModelDef, **changes) -> ModelDef:
    """A 2G-GCN ModelDef with fields of its config replaced and its init
    and apply closed over the new config (``tggcn/models/registry.py:24-42``);
    parameter trees stay valid across the fields worth replacing."""
    if model.name != "2G-GCN":
        raise ValueError(f"with_config_changes only supports 2G-GCN models, got {model.name}")
    return _tggcn_model(model.name, dataclasses.replace(model.config, **changes), model.device)


def resolve_forward_only_kernel_routing(model: ModelDef) -> ModelDef:
    """The identity. JAX's counterpart (``tggcn/models/registry.py:45-61``)
    upgrades its segment-kernel routing 'auto' to 'all' for a forward-only
    caller; the port has no routing to resolve: ``TGGCNConfig.from_kwargs``
    drops JAX's routing knobs, and every configuration runs K1-K5 wherever
    JAX's 'all' runs its kernels."""
    return model


def to_device(tree, device):
    """A tree of dicts and lists of tensors with every tensor on device."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
