"""Multi-process data parallelism (counterpart of ``tggcn/parallel/distributed.py``).

One process a device, joined in a ``torch.distributed`` process group:
NCCL on the card, gloo on the CPU. Every process runs the same
deterministic input pipeline (the loaders' order is a function of (seed,
epoch)), so each holds the whole global batch on its device and computes
on its own rows of it (``BatchShard``). The train step
(``tggcn_torch/train/loop.py``) gives the single-process step's result on
the global batch, as JAX's sharded step does:

  * the GeoGCN BatchNorm normalises with the statistics of every global row
    (its input, data, is gathered: the one-process statistics bit for bit);
  * the heads' outputs are gathered (``BatchShard.gather``) and the loss
    bundle runs on the global batch on every process, so each loss divides
    by the global batch's count of unmasked targets, and the multi-task
    weighting sees the global losses;
  * the Gumbel draws are those of the global batch, of which a process
    takes its rows;
  * the gradients are summed over the processes before clipping
    (``reduce_gradients``), and Adam then steps the same bits everywhere.

The weights, the BatchNorm state, the MTLL log-sigmas and Adam's state
start as process 0's (``replicate_global``). Checkpoints, scalars and
progress lines are written by process 0 alone.

Launch contract (one of):
  * explicit kwargs, ``maybe_initialize(coordinator_address=...,
    num_processes=..., process_id=...)`` (from ``resources.distributed.*``);
  * the environment variables TGGCN_COORDINATOR, TGGCN_NUM_PROCESSES and
    TGGCN_PROCESS_ID (set by a per-host launcher, or by the train entry
    point when ``resources.num_devices > 1`` spawns its processes);
  * ``auto=True``: torchrun's ``env://`` variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT).

A process takes ``cuda:LOCAL_RANK``, or ``cuda:(rank % device_count)``
without that variable. NCCL needs one device a process; two processes on
one card join over gloo instead (``backend='gloo'``).
"""

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (or rank modulo the card
    count without that variable) on the card, the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    if os.environ.get("LOCAL_RANK"):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", process_index() % max(torch.cuda.device_count(), 1))


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, auto: bool = False,
                     device_type: str = "cuda", backend: Optional[str] = None) -> bool:
    """Join the process group if a launch contract is present.

    Returns True when the group was joined (now or earlier in this
    process), False for plain single-process runs: with no kwargs, no
    environment variables and ``auto=False`` it does nothing. The backend
    is NCCL for ``device_type='cuda'``, gloo for the CPU, unless given.
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("TGGCN_COORDINATOR")
    if num_processes is None and os.environ.get("TGGCN_NUM_PROCESSES"):
        num_processes = int(os.environ["TGGCN_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TGGCN_PROCESS_ID"):
        process_id = int(os.environ["TGGCN_PROCESS_ID"])
    if coordinator_address is None and not auto:
        return False
    if coordinator_address is not None and not auto and \
            (num_processes is None or process_id is None):
        # The rendezvous would wait for peers it cannot count and fail
        # obscurely at the timeout instead of reporting the launch gap.
        raise ValueError(
            "incomplete distributed launch contract: coordinator_address is "
            f"set but num_processes={num_processes!r}, "
            f"process_id={process_id!r}. Provide both (via "
            "resources.distributed.* or TGGCN_NUM_PROCESSES / "
            "TGGCN_PROCESS_ID), or use auto=True under torchrun.")
    if auto and coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if not os.environ.get(k)]
        if missing:
            raise ValueError(f"incomplete distributed launch contract: auto=True needs "
                             f"torchrun's environment, and {missing} are not set")
        init_method, num_processes, process_id = "env://", None, None
    else:
        init_method = f"tcp://{coordinator_address}"
    # Two workers' imports can serialize on a loaded host: wait long.
    timeout = datetime.timedelta(seconds=int(os.environ.get("TGGCN_DIST_INIT_TIMEOUT", "600")))
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        rank = process_id if process_id is not None else int(os.environ["RANK"])
        if os.environ.get("LOCAL_RANK"):
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        else:
            torch.cuda.set_device(rank % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes or -1,
                            rank=-1 if process_id is None else process_id, timeout=timeout)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the process that owns checkpoint and log writes."""
    return process_index() == 0


def is_multiprocess() -> bool:
    """True in a process group of more than one process."""
    return process_count() > 1


def _collective_device() -> torch.device:
    """Where a small host value goes for a collective: NCCL takes tensors
    on the card only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assert_same_across_processes(value: int, what: str) -> None:
    """Raise when an integer differs across processes (e.g. the epoch each
    process restored from last.ckpt: a process that misses the snapshot
    would silently restart from scratch and diverge)."""
    mine = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device())
    seen = [torch.zeros_like(mine) for _ in range(process_count())]
    dist.all_gather(seen, mine)
    seen = [int(x) for x in torch.cat(seen).tolist()]
    if min(seen) != max(seen):
        raise RuntimeError(
            f"{what} differs across processes ({seen}): every process must see the same "
            "state (is the run dir on shared storage?).")


@dataclass(frozen=True)
class BatchShard:
    """This process's rows [offset, offset + rows) of a global batch of
    global_rows rows, split in equal blocks in rank order."""
    offset: int
    rows: int
    global_rows: int

    @property
    def world(self) -> int:
        return self.global_rows // self.rows

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global-batch tensor (a view)."""
        return x[self.offset:self.offset + self.rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global-batch tensor of every process's rows x (rows leading).
        Every process computes the same function of it (the loss bundle,
        the BatchNorm statistics), so the gradient of this process's rows
        is its own gradient's block: the backward takes it and
        communicates nothing."""
        return _GatherRows.apply(x, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        parts = [torch.empty_like(x) for _ in range(shard.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.take(grad), None


def batch_shard(global_rows: int) -> BatchShard:
    """This process's block of a global batch (``make_global_batch``'s
    split): raises ValueError when the rows do not divide by the processes."""
    count = process_count()
    if global_rows % count:
        raise ValueError(f"global batch of {global_rows} rows does not split over "
                         f"{count} processes")
    rows = global_rows // count
    return BatchShard(process_index() * rows, rows, global_rows)


def make_global_batch(arrays: list) -> list:
    """This process's rows of each global-batch array (the counterpart of
    JAX's ``make_global_batch``: every process passes the whole batch)."""
    shard = batch_shard(len(arrays[0]))
    return [shard.take(x) for x in arrays]


def _broadcast_(x: torch.Tensor) -> None:
    if dist.get_backend() == "nccl" and x.device.type != "cuda":
        staged = x.to(_collective_device())
        dist.broadcast(staged, src=0)
        x.copy_(staged)
    else:
        dist.broadcast(x, src=0)


@torch.no_grad()
def replicate_global(tensors, optimizer=None) -> None:
    """Give every process process 0's tensors (weights, BatchNorm state,
    MTLL log-sigmas), and its optimizer's state, in place."""
    for x in tensors:
        _broadcast_(x)
    if optimizer is not None:
        for state in optimizer.state.values():
            for value in state.values():
                if torch.is_tensor(value):
                    _broadcast_(value)


@torch.no_grad()
def reduce_gradients(grads: list, groups=(None,)) -> None:
    """Sum the gradients over the processes, in place: over each process
    group in turn (None: every process), one flat buffer a group."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    for group in groups:
        dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
