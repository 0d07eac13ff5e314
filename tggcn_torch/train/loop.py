"""The train step of the port (counterpart of ``tggcn/train/loop.py:65-144``),
K steps fused into one call (``make_fused_train_steps``, the counterpart
of ``tggcn/train/loop.py:162-191``), the eval step, and the fit loop
(``train``, ``tggcn/train/loop.py:194-422``) that the train entry point
runs.

One step: forward with train=True, the loss bundle (optionally weighted by
the multi-task loss learner), backward (through the K2 and K4 kernels on
the card), global-norm clipping over the model's gradients only, Adam from
``torch.optim``, and the write-back of the GeoGCN BatchNorm statistics.

Data parallelism (``mesh``, ``tggcn_torch/parallel``): the step takes the
global batch on every process, computes on this process's rows of it, and
gives the single-process step's result on the global batch, as JAX's
sharded step does. The BatchNorm trains on the global rows' statistics; the
heads' outputs are gathered and the loss bundle (and the multi-task
weighting) runs on the global batch on every process, so each loss is the
mean over the global batch's unmasked targets; the Gumbel draws are the
global batch's; the gradients are summed over the processes before
clipping, the MTLL log-sigmas' (which every process computed from the
same global losses) entering from process 0 alone. Averaging the
gradients of per-process means instead would weigh a process's targets
by its own count, which a padded last batch or masked targets make
unequal.

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

import itertools
import time
from typing import Callable, Optional

import numpy as np
import torch

from tggcn_torch.compat.weights import params_to_numpy
from tggcn_torch.data.feeders import num_inputs as model_inputs, pad_batch
from tggcn_torch.models.tggcn import NOISE_STREAMS
from tggcn_torch.nn.distributions import (GUMBEL_STRATEGIES, frame_indexed_gumbel,
                                          gumbel_noise, noise_key)
from tggcn_torch.parallel.distributed import (batch_shard, is_main_process, is_multiprocess,
                                              reduce_gradients, replicate_global)
from tggcn_torch.train.checkpoint import save_last
from tggcn_torch.train.logging import ScalarWriter
from tggcn_torch.train.multi_task import apply_mtll, mtll_weights

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


def _rows(shard, data, noise):
    """This process's rows of the global batch's inputs and noise (both as
    they are without a shard)."""
    if shard is None:
        return data, noise
    noise = None if noise is None else {k: shard.take(v) for k, v in noise.items()}
    return [shard.take(x) for x in data], noise


def make_train_step(model, feeder: Callable, criterion: Callable, optimizer,
                    clip_gradient_at: float = 0.0, mtll: Optional[dict] = None,
                    use_kernels: bool = True, mesh=None):
    """A step(trainable, data, targets, generator=None, noise=None) ->
    (losses, raw_losses, aux) that updates ``trainable`` in place.

    ``optimizer`` is built over ``trainable_parameters(trainable)``. A
    parameter the loss does not reach gets a zero gradient, not None, so
    that Adam counts its steps as optax's global count does.
    use_kernels=False runs the kernels' plain versions, forward and
    backward (the reference route).

    With a ``mesh`` (``tggcn_torch.parallel.make_mesh``, in a joined
    process group) every process passes the same global batch, noise and
    generator, and gets the global losses; aux is of its own rows.
    """
    mtll_static = None if mtll is None else (mtll["loss_types"], mtll["mask"])

    def step(trainable, data, targets, generator=None, noise=None):
        params = trainable_parameters(trainable)
        for p in params:
            p.requires_grad_(True)
        shard = None if mesh is None else batch_shard(len(data[0]))
        data, noise = _rows(shard, data, noise)
        outputs, aux = model.apply(trainable["model"], train=True, generator=generator,
                                   noise=noise, use_kernels=use_kernels, shard=shard,
                                   **feeder(data))
        if shard is not None:
            outputs = [shard.gather(o) for o in outputs]
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
        if mesh is not None:
            if mtll_static is not None and not is_main_process():
                trainable["mtll"].grad.zero_()
            reduce_gradients([p.grad for p in params], mesh.gradient_groups())
        if clip_gradient_at:
            _clip_([p.grad for p in model_parameters(trainable["model"])], clip_gradient_at)
        optimizer.step()
        if aux["bn_state"] is not None:
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


def frame_indexed_noise_stack(generator: torch.Generator, k: int, b: int, t: int, humans: int,
                              objects: int) -> dict:
    """The frame-indexed noise of K steps (frames 0 to T-1), shaped as
    gumbel_noise_stack's: one key a step from ``generator``, as an eager
    step of a ``gs_noise='frame_indexed'`` model draws it."""
    frames = torch.arange(t, device=generator.device)
    keys = [noise_key(generator) for _ in range(k)]
    return {who: torch.stack([frame_indexed_gumbel(key, NOISE_STREAMS[who], frames, b, n)
                              for key in keys])
            for who, n in (("human", humans), ("object", objects))}


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
    ``gumbel_noise_stack`` (``frame_indexed_noise_stack`` for a
    frame-indexed model) draws it. Passing both, or noise_stack to a
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

    Fused steps run in one process, as JAX's take no mesh: in a process
    group of more than one process this raises ValueError.
    """
    if is_multiprocess():
        raise ValueError("fused train steps run in one process: data-parallel training "
                         "takes the eager step (make_train_step with a mesh)")
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
            draw = (frame_indexed_noise_stack if model.config.gs_noise == "frame_indexed"
                    else gumbel_noise_stack)
            return draw(generator, k, b, t, humans, objects)
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


# ---------------------------------------------------------------------------
# Evaluation and the fit loop (tggcn/train/loop.py:194-422)
# ---------------------------------------------------------------------------

EVAL_STREAM = 10_000_000         # the eval generator's key: (seed, EVAL_STREAM + epoch)
LOG_INTERVAL = 25                # train batches between progress lines


def keyed_generator(device, seed: int, index: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, index): the train
    step's draws are a function of the global step alone, so a resumed run
    draws what the uninterrupted one drew."""
    state = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def device_batches(loader, batch_size: int, num_inputs: int, device):
    """The loader's numpy batches, a partial one padded to batch_size
    (``data/feeders.py`` ``pad_batch``), as tensors on ``device``."""
    for batch in loader:
        yield [torch.from_numpy(np.ascontiguousarray(x)).to(device)
               for x in pad_batch(batch, batch_size, num_inputs)]


def make_eval_step(model, feeder: Callable, criterion: Callable, mtll: Optional[dict] = None,
                   mesh=None):
    """An eval_step(trainable, data, targets, generator=None) -> (losses,
    raw_losses): the forward with train=False, no gradient; with a mesh,
    of the global batch every process passes (as make_train_step)."""
    mtll_static = None if mtll is None else (mtll["loss_types"], mtll["mask"])

    @torch.no_grad()
    def eval_step(trainable, data, targets, generator=None):
        shard = None if mesh is None else batch_shard(len(data[0]))
        data, _ = _rows(shard, data, None)
        outputs, _ = model.apply(trainable["model"], train=False, generator=generator,
                                 shard=shard, **feeder(data))
        if shard is not None:
            outputs = [shard.gather(o) for o in outputs]
        raw_losses = criterion(outputs, targets, reduction="mean")
        losses = raw_losses
        if mtll_static is not None:
            losses = apply_mtll(trainable["mtll"], *mtll_static, raw_losses)
        return torch.stack(losses), torch.stack(raw_losses)

    return eval_step


def evaluate(eval_step, trainable, loader, fetcher, key: tuple, batch_size: int,
             num_inputs: int, device):
    """Mean losses and raw losses over a loader's batches, as numpy arrays
    (reference test(), train_utils.py:168-224); (None, None) for no batch.
    Each batch draws from ``keyed_generator(device, *key)`` afresh, as
    JAX's evaluate hands every batch one key."""
    total = total_raw = None
    num_batches = 0
    for batch in device_batches(loader, batch_size, num_inputs, device):
        data, targets = fetcher(batch)
        losses, raw = eval_step(trainable, data, targets,
                                generator=keyed_generator(device, *key))
        total = losses if total is None else total + losses
        total_raw = raw if total_raw is None else total_raw + raw
        num_batches += 1
    if num_batches == 0:
        return None, None
    return (total / num_batches).cpu().numpy(), (total_raw / num_batches).cpu().numpy()


def first_nan(named) -> Optional[str]:
    """The name of the first of named's (name, tensor) pairs whose tensor
    holds a NaN, or None; one host sync for all of them."""
    named = [(k, x) for k, x in named if x is not None]
    if not named:
        return None
    hits = torch.stack([torch.isnan(x.detach()).any() for _, x in named]).nonzero()
    return named[int(hits[0, 0])][0] if len(hits) else None


def raise_on_nan(named, where: str) -> None:
    """FloatingPointError naming where and the first of named's tensors
    that holds a NaN (first_nan); infinities pass, as under JAX's
    jax_debug_nans."""
    found = first_nan(named)
    if found is not None:
        raise FloatingPointError(f"debug_nans: a NaN in {found} at {where}")


def step_tensors(trainable: dict, losses, raw_losses, loss_names) -> list:
    """(name, tensor) of what a train step made, in the order it made them:
    each loss and raw loss, each parameter's gradient, each updated leaf of
    trainable (the BatchNorm state too), named by its path in the tree."""
    names = {id(x): "/".join(map(str, path)) for path, x in _leaves(trainable)}
    out = [(f"loss {n}", x) for n, x in zip(loss_names, losses)]
    out += [(f"raw loss {n}", x) for n, x in zip(loss_names, raw_losses)]
    out += [(f"the gradient of {names[id(p)]}", p.grad) for p in trainable_parameters(trainable)]
    return out + [(f"the updated {names[id(x)]}", x) for _, x in _leaves(trainable)]


def _print_eval(name, total, loss_names, losses, printer=print):
    tag = f"({name})"
    printer(f"{tag:>12} Loss: {total: 7.4f}", end="")
    for loss_name, loss in zip(loss_names, losses):
        printer(f"   {loss_name}: {loss: 6.4f}", end="")
    printer()


def _silent(*_args, **_kwargs):
    pass


def train(model, train_loader, learning_rate: float, criterion, epochs: int, loss_names,
          clip_gradient_at: float = 0.0, fetch_model_data=None, feed_model_data=None,
          val_loader=None, initial_epoch: int = 1, mtll: Optional[dict] = None,
          num_main_losses: Optional[int] = None, seed: int = 42,
          checkpoint_name: Optional[str] = None, tensorboard_log_dir: Optional[str] = None,
          log_dir: Optional[str] = None, init_params=None, init_optimizer_state=None,
          initial_global_step: int = 0,
          initial_best_val_loss: float = float("inf"),
          initial_checkpoint: Optional[dict] = None, mesh=None, debug_nans: bool = False):
    """The fit loop (reference train(), train_utils.py:12-165): per epoch the
    train steps (Adam at learning_rate over ``trainable_parameters``), the
    mean losses over the whole train set and then the val set, the best
    val checkpoint, the loss histories (and, with the multi-task loss
    learner, the raw ones), scalars, and the ``last.ckpt`` snapshot.
    Returns the checkpoint dict. A partial batch pads the model's input
    arrays (``data/feeders.py`` ``num_inputs`` of ``model.name``) and gives
    its targets' pad rows -1.

    Step k draws from ``keyed_generator(device, seed, k)`` and each batch
    of epoch e's evaluations from ``keyed_generator(device, seed,
    EVAL_STREAM + e)``; the loader's order is a function of the epoch
    (``set_epoch``). A run resumed from ``last.ckpt`` (the initial_*
    arguments, the optimizer's state) so replays the uninterrupted run.

    With a ``mesh`` every process of the group runs this loop on the same
    batches (make_train_step's data parallelism), from process 0's
    weights and optimizer state; process 0 alone prints and writes the
    scalars and ``last.ckpt``.

    With ``debug_nans`` (the CLI's ``resources.debug_nans``, JAX's
    ``jax_debug_nans``) each train step's losses, gradients and updated
    leaves, and each eval step's losses, are read for a NaN after the
    step (one host sync a step), and the first raises FloatingPointError
    naming the epoch, the step and the first tensor at fault. Without it
    the loop reads nothing more than it did.
    """
    device = model.device
    num_inputs = model_inputs(model.name)
    log = print
    if mesh is not None and not is_main_process():
        log, tensorboard_log_dir, log_dir = _silent, None, None
    writer = ScalarWriter(tensorboard_log_dir, checkpoint_name)
    trainable = {"model": init_params}
    if mtll is not None:
        trainable["mtll"] = mtll["log_sds"]
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=learning_rate)
    if init_optimizer_state is not None:
        optimizer.load_state_dict(init_optimizer_state)
    if mesh is not None:
        replicate_global([x for _, x in _leaves(trainable)], optimizer)
    train_step = make_train_step(model, feed_model_data, criterion, optimizer,
                                 clip_gradient_at=clip_gradient_at, mtll=mtll, mesh=mesh)
    eval_step = make_eval_step(model, feed_model_data, criterion, mtll=mtll, mesh=mesh)

    def eval_step_of(split, epoch):
        """The eval step of one evaluation, under debug_nans checked."""
        if not debug_nans:
            return eval_step
        count = itertools.count()

        def checked(trainable, data, targets, generator=None):
            losses, raw = eval_step(trainable, data, targets, generator=generator)
            where = f"epoch {epoch}, {split} eval step {next(count)}"
            raise_on_nan([(f"loss {n}", x) for n, x in zip(loss_names, losses)]
                         + [(f"raw loss {n}", x) for n, x in zip(loss_names, raw)], where)
            return losses, raw
        return checked

    batch_size = train_loader.batch_size
    checkpoint = dict(initial_checkpoint) if initial_checkpoint else {}
    histories = {key: list(checkpoint.pop(key, [])) for key in (
        "train_losses", "val_losses", "train_raw_losses", "val_raw_losses")}
    best_val_loss = initial_best_val_loss
    global_step = initial_global_step
    num_examples = train_loader.num_examples

    def keep_best(epoch):
        checkpoint["epoch"] = epoch
        checkpoint["model_state_dict"] = params_to_numpy(trainable["model"])
        if mtll is not None:
            checkpoint["mtll_model_state_dict"] = params_to_numpy(trainable["mtll"])

    def record(split, losses, raw, epoch):
        n_main = num_main_losses if num_main_losses is not None else len(losses)
        total = float(losses[-n_main:].sum())
        _print_eval({"train": "Train", "val": "Validation"}[split], total, loss_names, losses,
                    log)
        histories[f"{split}_losses"].append([total, losses.tolist()])
        if mtll is not None:
            histories[f"{split}_raw_losses"].append([float(raw[-n_main:].sum()), raw.tolist()])
        base = f"Loss/{split}_mtll/" if mtll is not None else f"Loss/{split}/"
        for loss_name, value in zip(loss_names, losses):
            writer.add_scalar(base + loss_name, value, epoch)
        writer.add_scalar(base + "total", total, epoch)
        if mtll is not None and split == "train":
            weights = mtll_weights(trainable["mtll"].detach().cpu(), mtll["loss_types"],
                                   mtll["mask"])
            for loss_name, value, weight in zip(loss_names, raw, weights):
                writer.add_scalar(f"Loss/train/{loss_name}", value, epoch)
                if weight is not None:
                    writer.add_scalar(f"Loss/mtll_weight/{loss_name}", weight, epoch)
            writer.add_scalar("Loss/train/total", float(raw[-n_main:].sum()), epoch)
        return total

    for epoch in range(initial_epoch, epochs + initial_epoch):
        log(f"\nEpoch: [{epoch:4d}/{epochs + initial_epoch - 1:4d}]")
        epoch_start = time.time()
        num_batches = len(train_loader)
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        batches = device_batches(train_loader, batch_size, num_inputs, device)
        for batch_idx, batch in enumerate(batches):
            data, targets = fetch_model_data(batch)
            losses, raw, _ = train_step(trainable, data, targets,
                                        generator=keyed_generator(device, seed, global_step))
            if debug_nans:
                raise_on_nan(step_tensors(trainable, losses, raw, loss_names),
                             f"epoch {epoch}, train step {batch_idx} (global step {global_step})")
            global_step += 1
            if batch_idx % LOG_INTERVAL == 0 or batch_idx == num_batches - 1:
                losses = losses.cpu().numpy()
                n_main = num_main_losses if num_main_losses is not None else len(losses)
                batch_end = min((batch_idx + 1) * batch_size, num_examples)
                progress = 100 * (batch_idx + 1) / num_batches
                log(f"(Train) Batch [{batch_end:6d}/{num_examples:6d} ({progress:3.0f}%)] ",
                    f"Loss: {float(losses[-n_main:].sum()): 8.4f}", end="")
                for loss_name, single in zip(loss_names, losses):
                    log(f"  {loss_name}: {single: 6.4f}", end="")
                log()
        train_seconds = time.time() - epoch_start

        eval_start = time.time()
        key = (seed, EVAL_STREAM + epoch)
        losses, raw = evaluate(eval_step_of("train", epoch), trainable, train_loader,
                               fetch_model_data, key, batch_size, num_inputs, device)
        record("train", losses, raw, epoch)
        if val_loader is not None and val_loader.num_examples > 0:
            losses, raw = evaluate(eval_step_of("val", epoch), trainable, val_loader,
                                   fetch_model_data, key, val_loader.batch_size, num_inputs,
                                   device)
            total_val = record("val", losses, raw, epoch)
            if total_val < best_val_loss:
                best_val_loss = total_val
                keep_best(epoch)
        else:
            keep_best(epoch)
        writer.add_scalar("perf/train_seconds", train_seconds, epoch)
        writer.add_scalar("perf/eval_seconds", time.time() - eval_start, epoch)
        writer.add_scalar("perf/epoch_seconds", time.time() - epoch_start, epoch)
        if log_dir is not None:
            save_last(log_dir, {"epoch": epoch, "trainable": trainable,
                                "optimizer": optimizer.state_dict(), "global_step": global_step,
                                "best_val_loss": best_val_loss,
                                "best_checkpoint": {**checkpoint, **histories}})

    log("Lowest val_loss is", best_val_loss)
    checkpoint.update(histories)
    writer.close()
    return checkpoint
