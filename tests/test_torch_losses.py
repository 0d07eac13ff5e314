"""The port's losses and multi-task loss learner against tggcn's on the CPU.

Same inputs (numpy, from a seed) into both: every loss primitive, with
targets at -1 (missing) and an all-missing target, both loss bundles, and
MTLL, values and gradients. Where a BCE target is missing the port's
gradient is zero, as torch's BCE gives it in the reference; JAX's eager
gradient is NaN there, so those entries are checked against zero. Tolerance rtol 1e-5, atol 1e-6: the same float32
operations up to the order of the sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tggcn.config import Config
from tggcn.train import losses as jax_losses
from tggcn.train import multi_task as jax_mtll
from tggcn_torch.train import losses
from tggcn_torch.train.multi_task import apply_mtll, init_mtll

RTOL, ATOL = 1e-5, 1e-6


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=RTOL, atol=ATOL)


def _log_probs(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x - np.log(np.exp(x).sum(axis=1, keepdims=True))


@pytest.mark.parametrize("missing", ["some", "all"])
def test_nll_loss(missing):
    rng = np.random.default_rng(0)
    lp = _log_probs(rng, (2, 5, 4, 3))
    target = rng.integers(0, 5, size=(2, 4, 3)).astype(np.float32)
    target[0, 1] = -1
    if missing == "all":
        target[:] = -1
    x = torch.tensor(lp, requires_grad=True)
    got = losses.nll_loss(x, torch.tensor(target))
    want, grad = jax.value_and_grad(lambda a: jax_losses.nll_loss(a, target))(lp)
    close(got, want)
    got.backward()
    close(x.grad, grad)
    close(losses.nll_loss(x, torch.tensor(target), reduction="sum"),
          jax_losses.nll_loss(lp, target, reduction="sum"))


@pytest.mark.parametrize("missing", ["some", "all"])
@pytest.mark.parametrize("weight", [1, 2])
def test_binary_cross_entropy_loss(missing, weight):
    """Includes inputs at 0 and 1, where torch's BCE clamps log at -100."""
    rng = np.random.default_rng(1)
    p = rng.uniform(0.01, 0.99, size=(2, 6, 2)).astype(np.float32)
    p[0, 0, 0], p[1, 2, 1] = 0.0, 1.0
    target = rng.integers(0, 2, size=p.shape).astype(np.float32)
    target[1, 3:] = -1
    if missing == "all":
        target[:] = -1
    x = torch.tensor(p, requires_grad=True)
    got = losses.binary_cross_entropy_loss(x, torch.tensor(target), positive_class_weight=weight)
    close(got, jax_losses.binary_cross_entropy_loss(p, target, positive_class_weight=weight))
    # The gradient is finite: zero at missing targets, as torch's BCE in the
    # reference gives, and JAX's elsewhere (JAX's eager gradient is NaN at a
    # masked input of 0).
    got.backward()
    missing = target == -1
    want = jax.grad(lambda a: jax_losses.binary_cross_entropy_loss(
        a, target, positive_class_weight=weight))(p)
    assert torch.isfinite(x.grad).all()
    assert not x.grad[torch.tensor(missing)].any()
    interior = ~missing & (p > 0) & (p < 1)
    np.testing.assert_allclose(x.grad.numpy()[interior], np.asarray(want)[interior],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("missing", ["some", "all"])
def test_budget_loss(missing):
    rng = np.random.default_rng(2)
    p = rng.uniform(size=(3, 5, 2)).astype(np.float32)
    target = np.zeros_like(p)
    target[0] = -1
    if missing == "all":
        target[:] = -1
    close(losses.budget_loss(torch.tensor(p), torch.tensor(target)),
          jax_losses.budget_loss(p, target))


MISCS = {
    "stage1": {"budget_loss": {"add": False}, "segmentation_loss": {"add": False},
               "first_level_loss_weight": 0.0, "anticipation_loss_weight": 1.0},
    "fixture": {"budget_loss": {"add": True, "human_weight": 0.5},
                "segmentation_loss": {"add": True, "weight": 0.8},
                "first_level_loss_weight": 0.3, "anticipation_loss_weight": 0.7},
    "pretrain": {"segmentation_loss": {"add": True, "pretrain": True},
                 "input_object_segmentation": True},
}


@pytest.mark.parametrize("dataset", ["mphoi", "cad120"])
@pytest.mark.parametrize("misc", sorted(MISCS))
def test_select_loss_bundle(dataset, misc):
    """Loss names, weights, values and gradients of the whole bundle."""
    rng = np.random.default_rng(3)
    b, t, e = 2, 4, 2
    n_bin = 2 if dataset == "cad120" else 1
    n_nll = 8 if dataset == "cad120" else 4
    outputs = [rng.uniform(0.05, 0.95, size=(b, t, e)).astype(np.float32)
               for _ in range(2 * n_bin)]
    outputs += [_log_probs(rng, (b, 5, t, e)) for _ in range(n_nll)]
    targets = [rng.integers(0, 2, size=(b, t, e)).astype(np.float32) for _ in range(2 * n_bin)]
    targets += [rng.integers(0, 5, size=(b, t, e)).astype(np.float32) for _ in range(n_nll)]
    targets[-1][0] = -1
    targets[0][:] = -1                     # an all-missing target
    targets[2 * n_bin][:] = -1             # and an all-missing NLL target
    criterion, names = losses.select_loss("2G-GCN", "multiple", dataset, MISCS[misc])
    jax_criterion, jax_names = jax_losses.select_loss(
        "2G-GCN", "multiple", dataset, Config({"misc": MISCS[misc]}))
    assert names == jax_names
    xs = [torch.tensor(o, requires_grad=True) for o in outputs]
    got = criterion(xs, [torch.tensor(y) for y in targets])
    want = jax_criterion(outputs, targets)
    for g, w in zip(got, want):
        close(g, w)
    sum(got).backward()
    want_grads = jax.grad(lambda o: sum(jax_criterion(o, targets)))(outputs)
    for x, w in zip(xs, want_grads):
        assert torch.isfinite(x.grad).all() and np.isfinite(np.asarray(w)).all()
        close(x.grad, w)
    assert (losses.decide_num_main_losses("2G-GCN", dataset, MISCS[misc])
            == jax_losses.decide_num_main_losses("2G-GCN", dataset, MISCS[misc]))
    assert losses.select_loss_types("2G-GCN", dataset) == jax_losses.select_loss_types(
        "2G-GCN", dataset, None)
    assert losses.select_loss_learning_mask("2G-GCN", dataset) == \
        jax_losses.select_loss_learning_mask("2G-GCN", dataset, None)


def test_multi_task_loss_learner():
    """MTLL weighting of every loss type, its regulariser and its gradient."""
    types = ["budget", "bce", "softmax", "mse", "mae", "softmax"]
    mask = [False, False, True, True, True, True]
    log_sds = np.array([0.1, -0.2, 0.3, -0.4, 0.5, 0.05], np.float32)
    raw = np.array([0.7, 1.3, 2.1, 0.4, 0.9, 1.7], np.float32)
    state = init_mtll(types, mask)
    assert state["loss_types"] == tuple(types) and state["mask"] == tuple(mask)
    assert torch.equal(state["log_sds"], torch.zeros(6))
    x = torch.tensor(log_sds, requires_grad=True)
    got = apply_mtll(x, types, mask, list(torch.tensor(raw)))
    want = jax_mtll.apply_mtll(jnp.asarray(log_sds), types, mask, list(raw))
    for g, w in zip(got, want):
        close(g, w)
    sum(got).backward()
    close(x.grad, jax.grad(lambda s: sum(jax_mtll.apply_mtll(s, types, mask, list(raw))))(
        jnp.asarray(log_sds)))
    with pytest.raises(ValueError):
        init_mtll(["hinge"])
