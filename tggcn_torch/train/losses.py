"""Loss primitives and the loss bundles of the 2G-GCN and the baselines (counterpart of
``tggcn/train/losses.py``).

The same functions, weights, ordering and loss names as the JAX package
(and the reference it follows); ``misc`` is a plain dict. A target equal to
the ignore value (-1) is masked out of every loss; a loss with no target
left is 0.
"""

from functools import partial
from typing import List

import torch


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor, ignore_index: int = -1,
             reduction: str = "mean") -> torch.Tensor:
    """NLL over log-probabilities, torch layout (B, C, d1, ...) vs (B, d1, ...)."""
    mask = target != ignore_index
    safe_target = torch.where(mask, target, torch.zeros_like(target)).long()
    gathered = torch.gather(log_probs, 1, safe_target[:, None])[:, 0]
    losses = -gathered * mask
    if reduction == "sum":
        return torch.sum(losses)
    count = torch.sum(mask)
    return torch.where(count > 0, torch.sum(losses) / torch.clamp(count, min=1),
                       losses.new_zeros(()))


def binary_cross_entropy_loss(input: torch.Tensor, target: torch.Tensor,
                              positive_class_weight: float = 1, ignore_value: float = -1,
                              reduction: str = "mean") -> torch.Tensor:
    """Masked BCE with renormalisation by the non-missing fraction."""
    mask = (target != ignore_value).to(input.dtype)
    num_nonmissing = torch.sum(mask)
    if positive_class_weight > 1:
        input = torch.where(target == 1.0, input ** positive_class_weight, input)
    # torch's binary_cross_entropy, as the reference calls it: each log term
    # clamped at -100, and a finite gradient where a masked entry is 0 (the
    # JAX package's eager gradient is NaN there; its compiled step is not).
    criterion = torch.nn.functional.binary_cross_entropy(input * mask, target * mask)
    criterion = criterion * input.numel() / torch.clamp(num_nonmissing, min=1.0)
    return torch.where(num_nonmissing > 0, criterion, criterion.new_zeros(()))


def budget_loss(input: torch.Tensor, target: torch.Tensor, ignore_value: float = -1,
                reduction: str = "mean") -> torch.Tensor:
    """Regulariser toward zero soft decisions (mask from the target)."""
    mask = (target != ignore_value).to(input.dtype)
    num_nonmissing = torch.sum(mask)
    criterion = torch.mean(input * mask) * input.numel() / torch.clamp(num_nonmissing, min=1.0)
    return torch.where(num_nonmissing > 0, criterion, criterion.new_zeros(()))


def multi_task_loss(input: list, target: list, loss_functions: list, weight: list = None,
                    ignore_value=-1, reduction: str = "mean") -> List[torch.Tensor]:
    """Apply each loss function to its (output, target) pair with its weight."""
    if weight is None:
        weight = [1.0] * len(input)
    criteria = []
    for input_, target_, loss_function, w in zip(input, target, loss_functions, weight):
        if loss_function is nll_loss:
            criterion = loss_function(input_, target_, ignore_index=ignore_value,
                                      reduction=reduction)
        else:
            criterion = loss_function(input_, target_, ignore_value=ignore_value,
                                      reduction=reduction)
        criteria.append(w * criterion)
    return criteria


def select_loss(model_name: str, model_input_type: str, dataset_name: str, misc: dict):
    """(criterion, loss_names) of a model for a dataset; ``misc`` is the
    configuration's misc block as a plain dict. The baselines take the
    negative log-likelihood of each head (``tggcn/train/losses.py:124-129``)."""
    if model_name == "bimanual_baseline":
        return partial(multi_task_loss, loss_functions=(nll_loss,)), ["NLL_SAR"]
    if model_name == "cad120_baseline":
        return (partial(multi_task_loss, loss_functions=(nll_loss, nll_loss)),
                ["NLL_SAR", "NLL_OAR"])
    if model_name != "2G-GCN":
        raise ValueError(f"Unknown model {model_name}")
    misc = misc or {}
    budget = misc.get("budget_loss", {})
    segmentation = misc.get("segmentation_loss", {})
    hb_weight = ob_weight = 0.0
    if budget.get("add", False):
        hb_weight = budget.get("human_weight", 1.0)
        ob_weight = budget.get("object_weight", 1.0)
    weight = [hb_weight, ob_weight] if dataset_name == "cad120" else [hb_weight]

    hs_weight = os_weight = 0.0
    s_weight = segmentation.get("weight", 1.0)
    add_segmentation_loss = segmentation.get("add", False)
    if add_segmentation_loss and not misc.get("input_human_segmentation", False):
        hs_weight = s_weight
    if add_segmentation_loss and not misc.get("input_object_segmentation", False):
        os_weight = s_weight
    weight += [hs_weight, os_weight] if dataset_name == "cad120" else [hs_weight]
    weight_val = 0.0 if add_segmentation_loss and segmentation.get("pretrain", False) else 1.0
    anticipation_loss_weight = misc.get("anticipation_loss_weight", 1.0)
    fl_loss_weight = misc.get("first_level_loss_weight", 0.0)
    if dataset_name == "cad120":
        weight += [fl_loss_weight] * 4
        weight += [weight_val, anticipation_loss_weight, weight_val, anticipation_loss_weight]
        functions = (budget_loss, budget_loss, binary_cross_entropy_loss,
                     binary_cross_entropy_loss) + (nll_loss,) * 8
        loss_names = ["B_HS", "B_OS", "BCE_HS", "BCE_OS",
                      "NLL_SAR_F", "NLL_SAP_F", "NLL_OAR_F", "NLL_OAP_F",
                      "NLL_SAR", "NLL_SAP", "NLL_OAR", "NLL_OAP"]
    else:
        weight += [fl_loss_weight] * 2
        weight += [weight_val, anticipation_loss_weight]
        functions = (budget_loss, binary_cross_entropy_loss) + (nll_loss,) * 4
        loss_names = ["B_HS", "BCE_HS", "NLL_SAR_F", "NLL_SAP_F", "NLL_SAR", "NLL_SAP"]
    return partial(multi_task_loss, loss_functions=functions, weight=weight), loss_names


def select_loss_types(model_name: str, dataset_name: str):
    if model_name != "2G-GCN":
        raise ValueError(f"Multi-task learning option not implemented for {model_name}")
    if dataset_name == "cad120":
        return ["budget"] * 2 + ["bce"] * 2 + ["softmax"] * 8
    return ["budget", "bce"] + ["softmax"] * 4


def select_loss_learning_mask(model_name: str, dataset_name: str):
    if model_name != "2G-GCN":
        raise ValueError(f"Multi-task learning option not implemented for {model_name}")
    if dataset_name == "cad120":
        return [False] * 4 + [True] * 8
    return [False] * 2 + [True] * 4


def decide_num_main_losses(model_name: str, dataset_name: str, misc: dict):
    """Tail slice of the loss list used for model selection and evaluation."""
    if model_name != "2G-GCN":
        return None
    add = misc.get("segmentation_loss", {}).get("add", False)
    pretrain = misc.get("segmentation_loss", {}).get("pretrain", False)
    if add and pretrain:
        return 10 if dataset_name == "cad120" else 5
    return 4 if dataset_name == "cad120" else 2
