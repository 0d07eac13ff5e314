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
card it raises. Configurations outside the port raise NotImplementedError
naming their ``ROADMAP.md`` item: several devices or processes, the
baseline models, ``gs_noise=frame_indexed``, the orbax checkpoint backend.
``resources.parity_mode`` is accepted: the port has one numerics mode
(float32 matmuls with TF32 off, ``runtime.py``).
"""

import os
import sys

import torch

from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.config import compose, save_config
from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
from tggcn_torch.data.loading import determine_num_classes, load_training_data
from tggcn_torch.models.registry import select_model, to_device
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
    distributed = resources.get("distributed", {}) or {}
    if (resources.get("num_devices") or 1) > 1 or any(
            distributed.get(k) for k in ("coordinator_address", "num_processes", "auto")):
        raise NotImplementedError(
            "resources.num_devices > 1 and distributed runs: data-parallel training is not "
            "ported (ROADMAP.md Queue 1 item 9)")
    if cfg.logging.get("checkpoint_backend", "pickle") == "orbax":
        raise NotImplementedError(ORBAX)
    for key in ("jax_profiler_dir", "debug_nans"):
        if resources.get(key):
            raise NotImplementedError(f"resources.{key} is a switch of the JAX package only")
    check_parity_mode(resources.get("parity_mode", "fast"))


def main(argv=None):
    """Train one run; returns its checkpoint dict ({} when a resumed run
    had nothing left to do)."""
    argv = sys.argv[1:] if argv is None else argv
    overrides, device = split_device(argv)
    cfg = compose(CONF_DIR, overrides=overrides)
    check_supported(cfg)
    device = resolve_device(device)

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
        print(f"Warm-started from {misc['pretrained_path']}: {count_merged(own, params)} "
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
    if log_dir is not None:
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
            print(f"Resumed from epoch {last['epoch']} ({log_dir}/last.ckpt)")

    num_epochs = max(cfg.optimization.epochs - (resume["initial_epoch"] - 1), 0)
    if num_epochs == 0:
        print(f"Run already completed ({cfg.optimization.epochs} epochs); nothing to do.")
        return {}
    checkpoint = train(model, train_loader, cfg.optimization.learning_rate, criterion,
                       num_epochs, loss_names,
                       clip_gradient_at=cfg.optimization.clip_gradient_at,
                       fetch_model_data=fetch, feed_model_data=feed, val_loader=val_loader,
                       mtll=mtll, num_main_losses=num_main_losses, seed=SEED,
                       checkpoint_name=checkpoint_name,
                       tensorboard_log_dir=cfg.logging.get("root_log_dir"), log_dir=log_dir,
                       init_params=params, **resume)
    if log_dir is not None:
        checkpoint["scalers"] = scalers
        save_checkpoint(log_dir, checkpoint, checkpoint_name)
    return checkpoint

