"""The batch adapters of the 2G-GCN and the baselines (counterpart of
``tggcn/data/loading.py:485-564``) and batch padding
(``tggcn/train/loop.py:43-62``).

A 2G-GCN batch is the positional list the loaders yield: for MPHOI and
Bimanual [x_human, x_objects, objects_mask, human_segmentation, hh, ho, oo
distances, steps_per_example] and then the targets; for CAD-120 the seventh
input is the object segmentation's place. A baseline batch is [x_human,
x_objects, objects_mask] and then the targets. The fetcher splits inputs
from targets, the feeder maps the inputs onto the model's keyword
arguments. Arrays may be numpy arrays or tensors.
"""

from functools import partial

import numpy as np
import torch

from tggcn_torch.models.baselines import BASELINES


def _ones(like):
    """Ones over the entity axes of a feature array (its last axis dropped)."""
    if isinstance(like, torch.Tensor):
        return torch.ones(like.shape[:-1], dtype=like.dtype, device=like.device)
    return np.ones(like.shape[:-1], dtype=like.dtype)


def num_inputs(model_name: str) -> int:
    """The input arrays a batch holds before its targets: 8 for the 2G-GCN,
    3 for the baselines (the root ``train.py:134``)."""
    return 8 if model_name == "2G-GCN" else 3


def generic_fetcher(dataset, n: int):
    """The first n arrays are inputs, the rest targets (reference fetchers.py:13)."""
    return list(dataset[:n]), list(dataset[n:])


def baseline_feeder(data, **_kwargs) -> dict:
    """Map a baseline's data list onto its keyword arguments."""
    return {"x_human": data[0], "x_objects": data[1], "objects_mask": data[2]}


def gcn_fetcher(dataset, **_kwargs):
    """Split the 2G-GCN batch list into (data, targets): every dataset has
    8 inputs."""
    return list(dataset[:8]), list(dataset[8:])


def gcn_forward_kwargs(data, input_human_segmentation: bool = False,
                       input_object_segmentation: bool = False,
                       impose_segmentation_pattern: int = 0,
                       make_attention_distance_based: bool = False,
                       dataset_name: str = "cad120", **_kwargs) -> dict:
    """Map the 2G-GCN data list onto model keyword arguments."""
    if impose_segmentation_pattern:
        if impose_segmentation_pattern != 1:
            raise ValueError(
                f"Segmentation pattern can only be 1, not {impose_segmentation_pattern}")
        human_segmentation = _ones(data[0])
    elif input_human_segmentation:
        human_segmentation = data[3]
    else:
        human_segmentation = None
    kwargs = {"x_human": data[0], "x_objects": data[1], "objects_mask": data[2],
              "human_segmentation": human_segmentation}
    hh = ho = oo = None
    if dataset_name == "cad120":
        if impose_segmentation_pattern:
            kwargs["objects_segmentation"] = _ones(data[1])
        elif input_object_segmentation:
            kwargs["objects_segmentation"] = data[4]
        else:
            kwargs["objects_segmentation"] = None
        if make_attention_distance_based:
            ho, oo = data[5], data[6]
    elif make_attention_distance_based:
        hh, ho, oo = data[4], data[5], data[6]
    kwargs.update(human_human_distances=hh, human_object_distances=ho,
                  object_object_distances=oo, steps_per_example=data[7])
    return kwargs


def select_model_data_fetcher(model_name: str, model_input_type: str, **kwargs):
    if model_name in BASELINES:
        return partial(generic_fetcher, n=num_inputs(model_name))
    if model_name != "2G-GCN":
        raise KeyError(model_name)
    return partial(gcn_fetcher, **kwargs)


def select_model_data_feeder(model_name: str, model_input_type: str, **kwargs):
    if model_name in BASELINES:
        return baseline_feeder
    if model_name != "2G-GCN":
        raise KeyError(model_name)
    return partial(gcn_forward_kwargs, **kwargs)


def pad_batch(batch: list, batch_size: int, num_inputs: int) -> list:
    """Pad a partial batch of numpy arrays to batch_size.

    Inputs are padded with zeros (1-D float arrays such as
    steps_per_example with ones, to keep divisions safe); targets with -1,
    which every loss masks out.
    """
    current = len(batch[0])
    if current == batch_size:
        return batch
    out = []
    for i, arr in enumerate(batch):
        if i < num_inputs:
            fill = 1.0 if (arr.ndim == 1 and np.issubdtype(arr.dtype, np.floating)) else 0
        else:
            fill = -1
        pad = np.full((batch_size - current,) + arr.shape[1:], fill, dtype=arr.dtype)
        out.append(np.concatenate([arr, pad], axis=0))
    return out
