"""The train step of the port (counterpart of ``tggcn/train/loop.py:65-144``)
and K steps fused into one call (``make_fused_train_steps``, the
counterpart of ``tggcn/train/loop.py:162-191``).

One step: forward with train=True, the loss bundle (optionally weighted by
the multi-task loss learner), backward (through the K2 and K4 kernels on
the card), global-norm clipping over the model's gradients only, Adam from
``torch.optim``, and the write-back of the GeoGCN BatchNorm statistics.

``trainable`` is {'model': parameter tree, ['mtll': log-sigmas]}. Its
tensors are updated in place. The BatchNorm running statistics are state,
not parameters: ``trainable_parameters`` leaves them out, so Adam never
moves them, and the step overwrites them with the forward's new ones.

JAX fuses K steps into one program with ``lax.scan``, so the host
dispatches nothing per step. The port captures one step in a CUDA graph
and replays it K times: the host then enqueues, per step, the copies of
that step's batch and noise into the graph's input buffers, one graph
launch and the copy of its losses out, and never waits for the card.
"""

from typing import Callable, Optional

import torch

from tggcn_torch.nn.distributions import GUMBEL_STRATEGIES, gumbel_noise
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


WARMUP_STEPS = 3        # PyTorch's whole-network capture recipe warms up 3 steps


def gumbel_noise_stack(generator: torch.Generator, k: int, b: int, t: int, humans: int,
                       objects: int) -> dict:
    """The Gumbel noise of K steps, {'human': (K, B, T, H, 2), 'object':
    (K, B, T, O, 2)}, in one draw from ``generator`` on its device."""
    noise = gumbel_noise((k, b, t, humans + objects, 2), generator)
    return {"human": noise[:, :, :, :humans], "object": noise[:, :, :, humans:]}


def _snapshot(trainable: dict, optimizer) -> tuple:
    """Host copies of every tensor of trainable, and of the optimizer's
    state by parameter index (a parameter with no state yet has no entry);
    on the host, so that the capture's peak memory is the step's own."""
    host = lambda x: x.detach().to("cpu", copy=True)
    leaves = [host(x) for _, x in _leaves(trainable)]
    params = trainable_parameters(trainable)
    state = {i: {k: host(v) if torch.is_tensor(v) else v
                 for k, v in optimizer.state[p].items()}
             for i, p in enumerate(params) if p in optimizer.state}
    return leaves, state


@torch.no_grad()
def _restore(trainable: dict, optimizer, snapshot: tuple) -> None:
    """Write the snapshot back in place (the graph reads these addresses);
    state the optimizer made since is zeroed, which is Adam's fresh state."""
    leaves, state = snapshot
    for (_, x), saved in zip(_leaves(trainable), leaves):
        x.copy_(saved)
    for i, p in enumerate(trainable_parameters(trainable)):
        for k, v in optimizer.state[p].items():
            if not torch.is_tensor(v):
                continue
            if i in state:
                v.copy_(state[i][k])
            else:
                v.zero_()


def make_fused_train_steps(model, feeder: Callable, criterion: Callable, optimizer,
                           clip_gradient_at: float = 0.0, mtll: Optional[dict] = None,
                           use_kernels: bool = True):
    """A fused(trainable, data_stack, target_stack, generator=None,
    noise_stack=None) -> (losses (K, L), raw_losses (K, L)) that runs K
    steps of ``make_train_step`` and updates ``trainable`` in place.

    data_stack and target_stack are the fetcher's data and target lists
    with a leading axis of K steps (a view such as ``x.expand(K, *x.shape)``
    will do). A model with 'gs' decisions takes fresh Gumbel noise each
    step: ``noise_stack`` ({'human': (K, B, T, H, 2), 'object': (K, B, T,
    O, 2)}, both entries) where the caller gives it, else one draw a call
    from ``generator`` (default: a generator seeded 0, as apply draws), as
    ``gumbel_noise_stack`` draws it. Passing both, or noise_stack to a
    model without Gumbel decisions, raises ValueError.

    On the CPU, fused is the loop of K steps. On CUDA, the first call warms
    up WARMUP_STEPS steps on a side stream (which builds the kernels and
    the optimizer's state), captures one step in a torch.cuda.CUDAGraph
    over static buffers, and writes the weights and the optimizer's state
    back as they were; each call then copies each step's batch and noise
    into those buffers, replays the graph and copies the losses out. The
    graph reads the weights, the optimizer's state and the BatchNorm
    state by address, so later calls must pass the same ``trainable``,
    with inputs of the same shapes, on the model's device. The optimizer
    must be capturable (``torch.optim.Adam(..., capturable=True)``, whose
    step count lives on the card), or the call raises; a failed capture
    raises too, and nothing falls back to the eager loop.
    """
    step = make_train_step(model, feeder, criterion, optimizer, clip_gradient_at, mtll,
                           use_kernels)
    gumbel = model.config.discrete_optimization_strategy in GUMBEL_STRATEGIES
    graph = {}

    def noise_of(first_data, k, generator, noise_stack):
        if noise_stack is not None and generator is not None:
            raise ValueError("pass noise_stack or generator, not both")
        if not gumbel:
            if noise_stack is not None:
                raise ValueError("the model draws no Gumbel noise: it takes no noise_stack")
            return None
        inputs = feeder(first_data)
        b, t, humans = inputs["x_human"].shape[:3]
        objects = inputs["x_objects"].shape[2]
        if noise_stack is None:
            generator = generator or torch.Generator(device=model.device).manual_seed(0)
            return gumbel_noise_stack(generator, k, b, t, humans, objects)
        want = {"human": (k, b, t, humans, 2), "object": (k, b, t, objects, 2)}
        shapes = {w: tuple(v.shape) for w, v in noise_stack.items()}
        if shapes != want:
            raise ValueError(f"noise_stack must have the shapes {want}, not {shapes}")
        return noise_stack

    def at(noise, i):
        return None if noise is None else {w: v[i] for w, v in noise.items()}

    def capture(trainable, data, targets, noise):
        """The step's graph over static copies of step 0's inputs."""
        if not all(group.get("capturable", False) for group in optimizer.param_groups):
            raise ValueError("fused train steps on CUDA need a capturable optimizer, "
                             "e.g. torch.optim.Adam(params, lr, capturable=True)")
        static = dict(data=[x.clone() for x in data], targets=[y.clone() for y in targets],
                      noise=None if noise is None else {w: v.clone() for w, v in noise.items()})
        snapshot = _snapshot(trainable, optimizer)
        current = torch.cuda.current_stream(model.device)
        side = torch.cuda.Stream(model.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step(trainable, static["data"], static["targets"], noise=static["noise"])
        current.wait_stream(side)
        optimizer.zero_grad(set_to_none=True)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            losses, raw, _ = step(trainable, static["data"], static["targets"],
                                  noise=static["noise"])
        _restore(trainable, optimizer, snapshot)
        params = trainable_parameters(trainable)
        graph.update(static, graph=g, losses=losses, raw=raw, grads=[p.grad for p in params],
                     addresses=[x.data_ptr() for _, x in _leaves(trainable)],
                     buffers=static["data"] + static["targets"])

    def fused(trainable, data_stack, target_stack, generator=None, noise_stack=None):
        k = data_stack[0].shape[0]
        noise = noise_of([x[0] for x in data_stack], k, generator, noise_stack)
        if model.device.type != "cuda":
            out = [step(trainable, [x[i] for x in data_stack], [y[i] for y in target_stack],
                        noise=at(noise, i))[:2] for i in range(k)]
            return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
        stacks = [*data_stack, *target_stack]
        if not all(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in stacks + list((noise or {}).values())):
            raise ValueError(f"fused train steps on {model.device} take tensors on it: the "
                             "graph copies each step's inputs from them on the card")
        if not graph:
            capture(trainable, [x[0] for x in data_stack], [y[0] for y in target_stack],
                    at(noise, 0))
        if [x.data_ptr() for _, x in _leaves(trainable)] != graph["addresses"]:
            raise ValueError("these fused train steps were captured on another trainable")
        if [x.shape[1:] for x in stacks] != [x.shape for x in graph["buffers"]]:
            raise ValueError("these fused train steps were captured for inputs of other shapes")
        losses = graph["losses"].new_empty((k,) + graph["losses"].shape)
        raw = graph["raw"].new_empty((k,) + graph["raw"].shape)
        for i in range(k):
            for static, x in zip(graph["buffers"], stacks):
                static.copy_(x[i])
            for w, static in (graph["noise"] or {}).items():
                static.copy_(noise[w][i])
            graph["graph"].replay()
            losses[i].copy_(graph["losses"])
            raw[i].copy_(graph["raw"])
        for p, g in zip(trainable_parameters(trainable), graph["grads"]):
            p.grad = g
        return losses, raw

    return fused
