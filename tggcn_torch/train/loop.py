"""The train step of the port (counterpart of ``tggcn/train/loop.py:65-144``).

One step: forward with train=True, the loss bundle (optionally weighted by
the multi-task loss learner), backward (through the K2 and K4 kernels on
the card), global-norm clipping over the model's gradients only, Adam from
``torch.optim``, and the write-back of the GeoGCN BatchNorm statistics.

``trainable`` is {'model': parameter tree, ['mtll': log-sigmas]}. Its
tensors are updated in place. The BatchNorm running statistics are state,
not parameters: ``trainable_parameters`` leaves them out, so Adam never
moves them, and the step overwrites them with the forward's new ones.
"""

from typing import Callable, Optional

import torch

from tggcn_torch.train.multi_task import apply_mtll

BN_STATE = ("geometry_embedding_gcn", "bn", "state")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def model_parameters(params: dict) -> list:
    """The model's trainable tensors, in tree order, without the BatchNorm state."""
    return [x for path, x in _leaves(params) if path[:3] != BN_STATE]


def trainable_parameters(trainable: dict) -> list:
    """What the optimizer moves: the model's parameters, then the MTLL log-sigmas."""
    params = model_parameters(trainable["model"])
    if "mtll" in trainable:
        params.append(trainable["mtll"])
    return params


def _clip_(grads, max_norm: float) -> None:
    """Global-norm clipping in place (reference train_utils.py:152-153)."""
    total_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)


def make_train_step(model, feeder: Callable, criterion: Callable, optimizer,
                    clip_gradient_at: float = 0.0, mtll: Optional[dict] = None,
                    use_kernels: bool = True):
    """A step(trainable, data, targets, generator=None, noise=None) ->
    (losses, raw_losses, aux) that updates ``trainable`` in place.

    ``optimizer`` is built over ``trainable_parameters(trainable)``. A
    parameter the loss does not reach gets a zero gradient, not None, so
    that Adam counts its steps as optax's global count does.
    use_kernels=False runs the kernels' plain versions, forward and
    backward (the reference route).
    """
    mtll_static = None if mtll is None else (mtll["loss_types"], mtll["mask"])

    def step(trainable, data, targets, generator=None, noise=None):
        params = trainable_parameters(trainable)
        for p in params:
            p.requires_grad_(True)
        outputs, aux = model.apply(trainable["model"], train=True, generator=generator,
                                   noise=noise, use_kernels=use_kernels, **feeder(data))
        targets = [torch.as_tensor(t, device=model.device) for t in targets]
        raw_losses = criterion(outputs, targets, reduction="mean")
        losses = raw_losses
        if mtll_static is not None:
            losses = apply_mtll(trainable["mtll"], *mtll_static, raw_losses)
        optimizer.zero_grad(set_to_none=True)
        sum(losses).backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if clip_gradient_at:
            _clip_([p.grad for p in model_parameters(trainable["model"])], clip_gradient_at)
        optimizer.step()
        with torch.no_grad():
            state = trainable["model"]["geometry_embedding_gcn"]["bn"]["state"]
            for k, v in aux["bn_state"].items():
                state[k].copy_(v)
        return (torch.stack([x.detach() for x in losses]),
                torch.stack([x.detach() for x in raw_losses]), aux)

    return step
