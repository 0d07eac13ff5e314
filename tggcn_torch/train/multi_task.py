"""Multi-task loss weighting by learned uncertainty (counterpart of
``tggcn/train/multi_task.py:19-58``).

One learnable log-sigma per loss: a 'softmax' loss is weighted by
exp(-2 log_sd), 'mse' by 0.5 exp(-2 log_sd), 'mae' by sqrt(2) exp(-log_sd),
and +log_sd is added; a static mask says which losses learn.
"""

import math
from typing import List, Optional

import torch

_VALID = {"mae", "mean_absolute_error", "mse", "mean_squared_error", "softmax",
          "budget", "bce"}


def init_mtll(loss_types: List[str], mask: Optional[List[bool]] = None,
              device=None) -> dict:
    for loss_type in loss_types:
        if loss_type not in _VALID:
            raise ValueError("loss_type must be one of 'softmax', 'mae' or 'mse'.")
    return {
        "log_sds": torch.zeros(len(loss_types), device=device),
        "loss_types": tuple(loss_types),
        "mask": tuple(mask) if mask is not None else (True,) * len(loss_types),
    }


def _loss_weight(loss_type: str, log_sd):
    if loss_type in {"mae", "mean_absolute_error"}:
        return math.sqrt(2.0) * torch.exp(-log_sd)
    if loss_type in {"mse", "mean_squared_error"}:
        return 0.5 * torch.exp(-2 * log_sd)
    return torch.exp(-2 * log_sd)


def apply_mtll(log_sds: torch.Tensor, loss_types, mask, losses: List[torch.Tensor]):
    """Weight each learnable loss and add its log-sigma regulariser."""
    if len(loss_types) != len(losses):
        raise ValueError("Specified loss types must match the number of input losses.")
    return [_loss_weight(loss_type, log_sds[i]) * loss + log_sds[i] if learnable else loss
            for i, (loss_type, loss, learnable) in enumerate(zip(loss_types, losses, mask))]


def mtll_weights(log_sds, loss_types, mask) -> List[Optional[float]]:
    """The current learned weights (None for a loss that does not learn)."""
    return [float(_loss_weight(loss_type, log_sds[i])) if learnable else None
            for i, (loss_type, learnable) in enumerate(zip(loss_types, mask))]
