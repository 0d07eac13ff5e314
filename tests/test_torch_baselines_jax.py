"""The port's baselines against the JAX package's on the CPU.

* ``init_baseline``'s tree: the same leaf paths and shapes as JAX's, for
  each head layout.
* ``apply_baseline`` with JAX's weights carried over (``params_from_numpy``)
  against JAX's, over {bidirectional, not} x {message passing, not} x
  {CAD-120 (object head, 1 human), Bimanual (2 hands)}, at hidden 8, T 10,
  with a masked object: rtol 1e-5, atol 1e-5 (float32 log-probabilities;
  the recurrence sums in another order than XLA's scan).
* One step's gradients: the port's autograd through K1's and K2's plain
  versions against ``jax.grad`` of JAX's loss bundle (``select_loss``), on
  every leaf within 1e-4 of its largest value (the carried gradient sums
  over the sequence).
* The registry: ``select_model`` for both baselines, ``with_config_changes``
  and the identity ``resolve_forward_only_kernel_routing``.
* Run dirs: a port checkpoint read by the JAX package's
  ``load_model_weights`` and the other way round give the same outputs.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tggcn.models.baselines import BaselineConfig as JaxBaselineConfig
from tggcn.models.baselines import apply_baseline as jax_apply
from tggcn.models.baselines import init_baseline as jax_init
from tggcn.models.registry import select_model as jax_select_model
from tggcn.train.checkpoint import load_model_weights as jax_load_weights
from tggcn.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tggcn.train.losses import select_loss as jax_select_loss
from tggcn_torch.compat.weights import params_from_numpy, params_to_numpy
from tggcn_torch.models.baselines import BaselineConfig, apply_baseline, init_baseline
from tggcn_torch.models.registry import (resolve_forward_only_kernel_routing, select_model,
                                         with_config_changes)
from tggcn_torch.train.checkpoint import load_model_weights, save_checkpoint
from tggcn_torch.train.losses import select_loss

DATASETS = {"cad120": ("cad120_baseline", (40, 24), (10, 12), 1),
            "bimanual": ("bimanual_baseline", (44, 24), (14, None), 2)}
OBJECTS, T, HIDDEN = 3, 10, 8


def _kwargs(dataset, **changes):
    _, input_size, num_classes, _ = DATASETS[dataset]
    return dict(input_size=input_size, num_classes=num_classes, hidden_size=HIDDEN, **changes)


def _batch(dataset, seed=0):
    _, (human_in, object_in), (n_sa, n_af), humans = DATASETS[dataset]
    rng = np.random.default_rng(seed)
    b = 2
    mask = np.ones((b, OBJECTS), np.float32)
    mask[1, -1] = 0.0
    x = dict(x_human=rng.normal(size=(b, T, humans, human_in)).astype(np.float32),
             x_objects=rng.normal(size=(b, T, OBJECTS, object_in)).astype(np.float32),
             objects_mask=mask)
    targets = [rng.integers(0, n_sa, size=(b, T, humans)).astype(np.float32)]
    if n_af is not None:
        y_o = rng.integers(0, n_af, size=(b, T, OBJECTS)).astype(np.float32)
        y_o[1, :, -1] = -1.0
        targets.append(y_o)
    return x, targets


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree) for p, s in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tuple(tree.shape)}


def _jax_params(dataset, **changes):
    name = DATASETS[dataset][0]
    cfg = JaxBaselineConfig.from_kwargs(with_object_head=name == "cad120_baseline",
                                        **_kwargs(dataset, **changes))
    return cfg, jax_init(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("dataset, changes", [
    ("cad120", {}), ("bimanual", {}), ("cad120", {"bidirectional": False,
                                                  "with_message_passing": False})])
def test_init_tree_matches_jax(dataset, changes):
    jax_cfg, jax_params = _jax_params(dataset, **changes)
    cfg = BaselineConfig.from_kwargs(with_object_head=jax_cfg.with_object_head,
                                     **_kwargs(dataset, **changes))
    assert cfg.__dict__ == jax_cfg.__dict__
    assert _paths(init_baseline(torch.Generator().manual_seed(0), cfg)) == _paths(jax_params)


CASES = list(itertools.product(DATASETS, [True, False], [True, False]))


@pytest.mark.parametrize("dataset, bidirectional, message_passing", CASES,
                         ids=[f"{d}-bd{int(b)}-mp{int(m)}" for d, b, m in CASES])
def test_apply_matches_jax(dataset, bidirectional, message_passing):
    changes = dict(bidirectional=bidirectional, with_message_passing=message_passing)
    jax_cfg, jax_params = _jax_params(dataset, **changes)
    x, _ = _batch(dataset)
    want = jax_apply(jax_params, jax_cfg, x["x_human"], x["x_objects"], x["objects_mask"])
    model = select_model(DATASETS[dataset][0], device="cpu", **_kwargs(dataset, **changes))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    got, aux = model.apply(params, **x)
    assert aux == {"bn_state": None} and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("dataset", list(DATASETS))
def test_gradients_match_jax(dataset):
    name = DATASETS[dataset][0]
    jax_cfg, jax_params = _jax_params(dataset)
    x, targets = _batch(dataset, seed=1)
    jax_criterion, _ = jax_select_loss(name, "multiple", dataset, None)

    def jax_loss(params):
        out = jax_apply(params, jax_cfg, x["x_human"], x["x_objects"], x["objects_mask"])
        return sum(jax_criterion(out, [jnp.asarray(t) for t in targets]))

    want = jax.grad(jax_loss)(jax_params)
    model = select_model(name, device="cpu", **_kwargs(dataset))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    leaves = jax.tree_util.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    criterion, _ = select_loss(name, "multiple", dataset, {})
    out, _ = model.apply(params, train=True, **x)
    sum(criterion(out, [torch.as_tensor(t) for t in targets])).backward()
    for (path, w), p in zip(jax.tree_util.tree_leaves_with_path(want), leaves):
        w = np.asarray(w)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-12), (path, err)


def test_registry_matches_jax():
    for dataset in DATASETS:
        name = DATASETS[dataset][0]
        ours = select_model(name, device="cpu", compute_dtype="bfloat16", **_kwargs(dataset))
        theirs = jax_select_model(name, compute_dtype="bfloat16", **_kwargs(dataset))
        assert ours.name == theirs.name and ours.config.__dict__ == theirs.config.__dict__
        assert resolve_forward_only_kernel_routing(ours) is ours
        with pytest.raises(ValueError, match="only supports 2G-GCN"):
            with_config_changes(ours, hidden_size=16)
    tggcn = select_model("2G-GCN", device="cpu", input_size=(2152, 2048),
                         num_classes=(13, None), hidden_size=8, use_pallas_segment_scan=True,
                         segment_kernel_modes="auto")
    assert resolve_forward_only_kernel_routing(tggcn) is tggcn
    changed = with_config_changes(tggcn, hidden_size=12, attention_style="v1")
    assert changed.config.hidden_size == 12 and changed.config.attention_style == "v1"
    assert changed.device == tggcn.device
    params = changed.init(torch.Generator().manual_seed(0))
    assert params["human_bd_rnn"]["fwd"]["w_hh"].shape == (12, 36)


def test_run_dirs_are_read_across_packages(tmp_path):
    """A port checkpoint read by the JAX package, and a JAX checkpoint read
    by the port: the same parameters, so the same outputs."""
    jax_cfg, jax_params = _jax_params("cad120")
    x, _ = _batch("cad120", seed=2)
    want = jax_apply(jax_params, jax_cfg, x["x_human"], x["x_objects"], x["objects_mask"])
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    port_run, jax_run = tmp_path / "port_run", tmp_path / "jax_run"
    save_checkpoint(str(port_run), {"epoch": 1, "model_state_dict": params}, "port_run")
    jax_save_checkpoint(str(jax_run), {"epoch": 1, "model_state_dict": jax.tree_util.tree_map(
        np.asarray, jax_params)}, "jax_run")
    from_port = jax_load_weights(str(port_run))
    got_jax = jax_apply(from_port, jax_cfg, x["x_human"], x["x_objects"], x["objects_mask"])
    cfg = BaselineConfig.from_kwargs(with_object_head=True, **_kwargs("cad120"))
    got_port = apply_baseline(load_model_weights(str(jax_run), cfg=cfg), cfg,
                              *(torch.as_tensor(x[k]) for k in
                                ("x_human", "x_objects", "objects_mask")))
    assert _paths(params_to_numpy(params)) == _paths(from_port)
    for w, a, b in zip(want, got_jax, got_port):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
