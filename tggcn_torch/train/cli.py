"""The train entry point (counterpart of the root ``train.py``).

    python -m tggcn_torch.train models=2G-GCN_stage1 data=mphoi [overrides] [--device cpu]

The same configuration (the repo's ``conf/``, Hydra-style overrides), data
loading with the seed-42 split, model from ``cfg.parameters``, optional
stage-2 warm start from a run dir (``misc.pretrained_path``, a non-strict
merge), Adam, the loss bundle and the optional multi-task loss learner,
best-val checkpointing, ``misc.resume`` from ``last.ckpt``, and the run-dir
contract: the frozen config under ``.hydra/config.yaml`` and
``<checkpoint_name>.ckpt`` in ``logging.log_dir``.

The run takes the CUDA card unless ``--device cpu`` is given; without a
card it raises. The orbax checkpoint backend raises NotImplementedError.
``resources.parity_mode`` is accepted: the port has one numerics mode
(float32 matmuls with TF32 off, ``runtime.py``).

The two observability switches keep the JAX package's keys, since both
packages read the same ``conf/`` and run dirs:

* ``resources.jax_profiler_dir=DIR`` traces the span JAX traces, the whole
  fit loop (``train.py:179-195``), with ``torch.profiler``: host activity,
  and the card's where the run has one; at its end each process writes a
  Chrome trace, ``DIR/trace.rank<r>.json`` (``TRACE_FILE``), which
  chrome://tracing or Perfetto opens offline. DIR is made if missing.
* ``resources.debug_nans=true`` raises FloatingPointError at the first
  train or eval step whose losses, gradients or updated parameters hold a
  NaN, naming the epoch, the step and the first tensor at fault
  (``train/loop.py`` ``train``); JAX's ``jax_debug_nans`` raises at the
  first NaN of any jitted computation of the run.

Without them the fit loop reads nothing more and runs no profiler.

Data parallelism (``tggcn_torch/parallel``), as the root ``train.py``:
``resources.num_devices=N`` (N > 1) spawns N processes on this host, one a
device (``cuda:r`` over NCCL; with ``--device cpu``, N gloo processes), and
rendezvouses them on localhost; ``resources.distributed.*`` or the
TGGCN_COORDINATOR / TGGCN_NUM_PROCESSES / TGGCN_PROCESS_ID environment
joins this process to a group launched elsewhere, every process of which
is then in the run. More devices than present, or a batch size the
processes do not divide, raise ValueError. The launching call returns
process 0's checkpoint dict.
"""

import contextlib
import os
import pickle
import socket
import sys
import tempfile

import torch

from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.config import compose, save_config
from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
from tggcn_torch.data.loading import determine_num_classes, load_training_data
from tggcn_torch.models.registry import select_model, to_device
from tggcn_torch.parallel.distributed import (assert_same_across_processes, is_main_process,
                                              local_device, maybe_initialize, process_count,
                                              process_index)
from tggcn_torch.parallel.mesh import make_mesh
from tggcn_torch.runtime import check_parity_mode, resolve_device
from tggcn_torch.train.checkpoint import (ORBAX, count_merged, load_last, load_model_weights,
                                          merge_params, save_checkpoint)
from tggcn_torch.train.losses import (decide_num_main_losses, select_loss,
                                      select_loss_learning_mask, select_loss_types)
from tggcn_torch.train.loop import train
from tggcn_torch.train.multi_task import init_mtll

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "conf")
SEED = 42
TRACE_FILE = "trace.rank{rank}.json"


def split_device(argv):
    """(the overrides, the device of a ``--device X`` or ``--device=X``
    argument, None without one)."""
    rest, device, args = [], None, iter(argv)
    for arg in args:
        if arg == "--device":
            device = next(args, None)
            if device is None:
                raise SystemExit("--device needs a value: cuda or cpu")
        elif arg.startswith("--device="):
            device = arg.partition("=")[2]
        else:
            rest.append(arg)
    return rest, device


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a configuration outside the port."""
    resources = cfg.get("resources", default_value={})
    if cfg.logging.get("checkpoint_backend", "pickle") == "orbax":
        raise NotImplementedError(ORBAX)
    check_parity_mode(resources.get("parity_mode", "fast"))


@contextlib.contextmanager
def traced(directory, device):
    """torch.profiler over the block, written at its end as this process's
    Chrome trace in directory (TRACE_FILE); nothing without a directory."""
    if not directory:
        yield
        return
    os.makedirs(directory, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as profile:
        yield
    profile.export_chrome_trace(os.path.join(directory, TRACE_FILE.format(rank=process_index())))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank: int, argv: list, count: int, port: int, out: str) -> None:
    """Process ``rank`` of a one-host launch: join the group through the
    environment contract and run; process 0 leaves its checkpoint in out."""
    os.environ.update(TGGCN_COORDINATOR=f"127.0.0.1:{port}", TGGCN_NUM_PROCESSES=str(count),
                      TGGCN_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    checkpoint = main(argv)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(checkpoint, f)


def launch(argv: list, count: int) -> dict:
    """Run ``main(argv)`` in ``count`` spawned processes joined on
    localhost; returns process 0's checkpoint dict. A process that fails
    ends the others and raises here."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "checkpoint.pkl")
        torch.multiprocessing.start_processes(_spawned, args=(argv, count, _free_port(), out),
                                              nprocs=count, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


def main(argv=None):
    """Train one run; returns its checkpoint dict ({} when a resumed run
    had nothing left to do)."""
    argv = sys.argv[1:] if argv is None else argv
    overrides, device = split_device(argv)
    cfg = compose(CONF_DIR, overrides=overrides)
    check_supported(cfg)
    device = resolve_device(device)
    resources = cfg.get("resources", default_value={})
    dist_conf = resources.get("distributed", {}) or {}
    distributed = maybe_initialize(
        coordinator_address=dist_conf.get("coordinator_address"),
        num_processes=dist_conf.get("num_processes"), process_id=dist_conf.get("process_id"),
        auto=bool(dist_conf.get("auto", False)), device_type=device.type)
    num_devices = resources.get("num_devices") or 1
    if distributed:
        # A joined group's run spans every process (train.py:115-119).
        num_devices = num_devices if num_devices > 1 else process_count()
        if num_devices != process_count():
            raise ValueError(f"resources.num_devices={num_devices}, but the process group "
                             f"has {process_count()} processes")
        device = local_device(device.type)
    mesh = None
    if num_devices > 1:
        mesh = make_mesh(num_devices, device.type)
        if cfg.optimization.batch_size % num_devices != 0:
            raise ValueError(
                f"batch_size {cfg.optimization.batch_size} must be a multiple of num_devices "
                f"{num_devices} (the batch is sharded over the data mesh)")
        if not distributed:
            return launch(argv, num_devices)
    main_process = is_main_process()
    log = print if main_process else (lambda *_args, **_kwargs: None)

    model_name, input_type = cfg.metadata.model_name, cfg.metadata.input_type
    batch_size, val_fraction = cfg.optimization.batch_size, cfg.optimization.val_fraction
    misc = cfg.get("misc", default_value={})
    sigma = misc.get("segmentation_loss", {}).get("sigma", 0.0)
    train_loader, val_loader, data_info, scalers = load_training_data(
        cfg.data, model_name, input_type, batch_size=batch_size, val_fraction=val_fraction,
        seed=SEED, debug=bool(misc.get("debug", False)), sigma=sigma)

    dataset_name = cfg.data.name
    num_classes = determine_num_classes(model_name, input_type, dataset_name)
    model = select_model(model_name, device=device, num_classes=num_classes,
                         **{**data_info, **cfg.parameters})
    params = model.init(torch.Generator().manual_seed(SEED))
    if misc.get("pretrained", False) and misc.get("pretrained_path") is not None:
        own = params
        loaded = load_model_weights(misc["pretrained_path"], cfg=model.config)
        params = merge_params(own, to_device(loaded, model.device))
        log(f"Warm-started from {misc['pretrained_path']}: {count_merged(own, params)} "
            f"parameter leaves taken")

    criterion, loss_names = select_loss(model_name, input_type, dataset_name, misc)
    mtll = None
    if misc.get("multi_task_loss_learner", False):
        mtll = init_mtll(select_loss_types(model_name, dataset_name),
                         select_loss_learning_mask(model_name, dataset_name), device=device)
    fetch = select_model_data_fetcher(model_name, input_type, dataset_name=dataset_name,
                                      **{**misc, **cfg.parameters})
    feed = select_model_data_feeder(model_name, input_type, dataset_name=dataset_name, **misc)
    num_main_losses = decide_num_main_losses(model_name, dataset_name,
                                             {**misc, **cfg.parameters})

    log_dir = cfg.logging.get("log_dir")
    checkpoint_name = cfg.logging.get("checkpoint_name")
    if log_dir is not None and main_process:
        os.makedirs(log_dir, exist_ok=True)
        save_config(cfg, os.path.join(log_dir, ".hydra", "config.yaml"))

    resume = dict(initial_epoch=1, init_optimizer_state=None, initial_global_step=0,
                  initial_best_val_loss=float("inf"), initial_checkpoint=None)
    if misc.get("resume", False) and log_dir is not None:
        last = load_last(log_dir)
        if last is not None:
            params = params_from_numpy(last["trainable"]["model"], device)
            if mtll is not None and "mtll" in last["trainable"]:
                mtll["log_sds"] = torch.tensor(last["trainable"]["mtll"], device=device)
            resume = dict(initial_epoch=last["epoch"] + 1,
                          init_optimizer_state=last["optimizer"],
                          initial_global_step=last.get("global_step", 0),
                          initial_best_val_loss=last.get("best_val_loss", float("inf")),
                          initial_checkpoint=last.get("best_checkpoint"))
            log(f"Resumed from epoch {last['epoch']} ({log_dir}/last.ckpt)")
        if distributed:
            # Every process must restore the same snapshot: one that
            # missed last.ckpt would restart from scratch and diverge.
            assert_same_across_processes(resume["initial_epoch"],
                                         "misc.resume=true restored epoch")

    num_epochs = max(cfg.optimization.epochs - (resume["initial_epoch"] - 1), 0)
    if num_epochs == 0:
        log(f"Run already completed ({cfg.optimization.epochs} epochs); nothing to do.")
        return {}
    with traced(resources.get("jax_profiler_dir"), device):
        checkpoint = train(model, train_loader, cfg.optimization.learning_rate, criterion,
                           num_epochs, loss_names,
                           clip_gradient_at=cfg.optimization.clip_gradient_at,
                           fetch_model_data=fetch, feed_model_data=feed, val_loader=val_loader,
                           mtll=mtll, num_main_losses=num_main_losses, seed=SEED,
                           checkpoint_name=checkpoint_name,
                           tensorboard_log_dir=cfg.logging.get("root_log_dir"),
                           log_dir=log_dir, init_params=params, mesh=mesh,
                           debug_nans=bool(resources.get("debug_nans", False)), **resume)
    if log_dir is not None and main_process:
        checkpoint["scalers"] = scalers
        save_checkpoint(log_dir, checkpoint, checkpoint_name)
    return checkpoint

