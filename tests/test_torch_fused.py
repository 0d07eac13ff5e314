"""The port's fused train steps against the JAX reference on the CPU.

* K=3 steps of tggcn_torch.train.loop.make_fused_train_steps against JAX's
  make_fused_train_steps (tggcn/train/loop.py:162), stage-1 configuration
  at hidden 16, T=6, B=2, 2 humans, 3 objects, 'gs' decisions, Adam at
  stage 1's learning rate (1e-4, stage1.TRAIN) with global-norm clipping
  at 0.5, from the same weights (carried across by
  tggcn_torch.compat.weights), a different batch each step and each step's
  Gumbel noise as JAX draws it from its split keys, passed as noise_stack:
  losses (K, L) rtol 1e-5, atol 1e-6; weights and BatchNorm state atol
  1e-5 (tests/test_torch_train.py's limits for one step). Adam's step,
  lr m / (sqrt(v) + eps), is near lr wherever a gradient is float32
  rounding noise, so the weights' gap grows with lr and the steps: at lr
  1e-3 one weight of 32768 lies 1.26e-5 from JAX's after 3 steps.
* On the CPU fused is the loop of K make_train_step steps: the same bits,
  with a noise_stack and with noise drawn from a generator; noise_stack and
  generator are refused together, and a noise_stack of the wrong shape.
* apply draws the Gumbel noise of 'gs' decisions on the generator's device,
  the humans' and then the objects', and reads nothing back to the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tggcn.config import Config
from tggcn.data.loading import select_model_data_feeder as jax_feeder
from tggcn.models import select_model as jax_select_model
from tggcn.train.loop import make_fused_train_steps as jax_make_fused_train_steps
from tggcn.train.losses import select_loss as jax_select_loss
from tggcn_torch.compat.weights import params_from_numpy, params_to_numpy
from tggcn_torch.data.feeders import select_model_data_feeder
from tggcn_torch.models.registry import select_model
from tggcn_torch.nn.distributions import gumbel_noise
from tggcn_torch.train.loop import (gumbel_noise_stack, make_fused_train_steps,
                                    make_train_step, trainable_parameters)
from tggcn_torch.train.losses import select_loss

STAGE1 = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=16,
              gcn_node=26, message_segment=True, message_type="v2",
              message_granularity="v1", message_aggregation="att",
              attention_style="v3", object_segment_update_strategy="ind",
              discrete_optimization_strategy="gs")
MISC = {"budget_loss": {"add": True, "human_weight": 0.5},
        "segmentation_loss": {"add": True, "weight": 0.8},
        "first_level_loss_weight": 0.3, "anticipation_loss_weight": 0.7}
K, B, T, NH, NO = 3, 2, 6, 2, 3
LR, CLIP = 1e-4, 0.5            # stage1.TRAIN["lr"]; clipping at a norm the gradient exceeds


def _batch(seed):
    """The 2G-GCN batch list: 8 inputs, then the six MPHOI targets with some
    entries missing (-1)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, NO), np.float32)
    mask[0, -1] = 0.0
    mask[1, 1:] = 0.0
    dummy = np.zeros((B, 1, 1, 1), np.float32)
    y_seg = rng.integers(0, 2, size=(B, T, NH)).astype(np.float32)
    y_rec = rng.integers(0, 13, size=(B, T, NH)).astype(np.float32)
    y_rec[1, -2:] = -1
    return [rng.normal(size=(B, T, NH, 2152)).astype(np.float32),
            rng.normal(size=(B, T, NO, 2048)).astype(np.float32), mask,
            np.ones((B, T, NH), np.float32), dummy, dummy, dummy,
            np.full((B,), float(T), np.float32),
            y_seg, y_seg, y_rec, y_rec, y_rec, y_rec]


def _stacks():
    """(data_stack, target_stack) as numpy arrays, K steps leading, one batch a step."""
    batches = [_batch(seed=40 + i) for i in range(K)]
    stacked = [np.stack([batch[j] for batch in batches]) for j in range(14)]
    return stacked[:8], stacked[8:]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _port(params_np):
    """The port's model, trainable, loss bundle, feeder and Adam from numpy weights."""
    model = select_model("2G-GCN", device="cpu", **STAGE1)
    trainable = {"model": params_from_numpy(params_np)}
    criterion, _ = select_loss("2G-GCN", "multiple", "mphoi", MISC)
    feeder = select_model_data_feeder("2G-GCN", "multiple", dataset_name="mphoi")
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=LR, betas=(0.9, 0.999),
                                 eps=1e-8)
    return model, trainable, criterion, feeder, optimizer


def test_fused_steps_match_jax():
    jax_model = jax_select_model("2G-GCN", **STAGE1)
    jax_params = jax_model.init(jax.random.PRNGKey(41))
    params_np = jax.tree_util.tree_map(np.asarray, jax_params)
    data_stack, target_stack = _stacks()
    jax_criterion, _ = jax_select_loss("2G-GCN", "multiple", "mphoi", Config({"misc": MISC}))
    optimizer = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jax_fused = jax_make_fused_train_steps(
        jax_model, jax_feeder("2G-GCN", "multiple", dataset_name="mphoi"), jax_criterion,
        optimizer, clip_gradient_at=CLIP)
    rng = jax.random.PRNGKey(42)
    trainable = {"model": jax_params}
    trainable, _, want_losses, want_raw = jax_fused(
        trainable, optimizer.init(trainable), rng, [jnp.asarray(x) for x in data_stack],
        [jnp.asarray(y) for y in target_stack])
    # The noise each step's apply drew: fused splits rng into K step keys,
    # apply splits a step's key into the humans' and the objects'.
    keys = [jax.random.split(key) for key in jax.random.split(rng, K)]
    noise_stack = {who: torch.tensor(np.stack([np.asarray(jax.random.gumbel(
        key[i], (B, T, n, 2), jnp.float32)) for key in keys]))
        for i, (who, n) in enumerate((("human", NH), ("object", NO)))}

    model, port, criterion, feeder, adam = _port(params_np)
    fused = make_fused_train_steps(model, feeder, criterion, adam, clip_gradient_at=CLIP)
    losses, raw = fused(port, data_stack, target_stack, noise_stack=noise_stack)
    assert losses.shape == raw.shape == (K, 6)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), rtol=1e-5, atol=1e-6)
    got = {k: v.detach().numpy() for k, v in _flat(port["model"]).items()}
    want = {k: np.asarray(v) for k, v in _flat(trainable["model"]).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert not np.allclose(got["/geometry_embedding_gcn/bn/state/var"],
                           np.asarray(params_np["geometry_embedding_gcn"]["bn"]["state"]["var"]))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_flat(a).values(), _flat(b).values()))


def test_fused_steps_are_the_loop_of_steps_on_the_cpu():
    """fused equals K make_train_step calls exactly, with a noise_stack and
    with the stack it draws from a generator; the optimizer's state too."""
    params_np = params_to_numpy(select_model("2G-GCN", device="cpu", **STAGE1).init(
        torch.Generator().manual_seed(43)))
    data_stack, target_stack = _stacks()
    for noise_of in ("stack", "generator"):
        model, loop_tree, criterion, feeder, loop_adam = _port(params_np)
        noise = gumbel_noise_stack(torch.Generator().manual_seed(44), K, B, T, NH, NO)
        step = make_train_step(model, feeder, criterion, loop_adam, clip_gradient_at=CLIP)
        want = torch.stack([step(loop_tree, [x[i] for x in data_stack],
                                 [y[i] for y in target_stack],
                                 noise={w: v[i] for w, v in noise.items()})[0]
                            for i in range(K)])
        _, fused_tree, _, _, fused_adam = _port(params_np)
        fused = make_fused_train_steps(model, feeder, criterion, fused_adam,
                                       clip_gradient_at=CLIP)
        given = (dict(noise_stack=noise) if noise_of == "stack"
                 else dict(generator=torch.Generator().manual_seed(44)))
        got, _ = fused(fused_tree, data_stack, target_stack, **given)
        assert torch.equal(got, want), noise_of
        assert _equal(fused_tree, loop_tree), noise_of
        for p, q in zip(trainable_parameters(fused_tree), trainable_parameters(loop_tree)):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(fused_adam.state[p][key], loop_adam.state[q][key])


def test_fused_steps_refuse_what_they_cannot_use():
    """noise_stack with a generator, a noise_stack short of an entry or of a
    step, and a noise_stack for a model without Gumbel decisions raise
    before any step runs."""
    params_np = params_to_numpy(select_model("2G-GCN", device="cpu", **STAGE1).init(
        torch.Generator().manual_seed(45)))
    data_stack, target_stack = _stacks()
    model, tree, criterion, feeder, adam = _port(params_np)
    fused = make_fused_train_steps(model, feeder, criterion, adam)
    noise = gumbel_noise_stack(torch.Generator().manual_seed(46), K, B, T, NH, NO)
    before = {k: v.clone() for k, v in _flat(tree).items()}
    with pytest.raises(ValueError, match="not both"):
        fused(tree, data_stack, target_stack, noise_stack=noise,
              generator=torch.Generator().manual_seed(0))
    for bad in ({"object": noise["object"]},
                {w: v[:K - 1] for w, v in noise.items()},
                {"human": noise["human"], "object": noise["human"]}):
        with pytest.raises(ValueError, match="shapes"):
            fused(tree, data_stack, target_stack, noise_stack=bad)
    st = select_model("2G-GCN", device="cpu", **dict(STAGE1, discrete_optimization_strategy="st"))
    with pytest.raises(ValueError, match="no Gumbel noise"):
        make_fused_train_steps(st, feeder, criterion, adam)(tree, data_stack, target_stack,
                                                            noise_stack=noise)
    assert _equal(tree, before)


def test_apply_draws_gumbel_noise_without_reading_the_host(monkeypatch):
    """With no noise given, a 'gs' forward with nothing imposed draws the
    humans' noise and then the objects' from the one generator it is given,
    on its device, and reads no tensor back to the host."""
    model = select_model("2G-GCN", device="cpu", **STAGE1)
    params = model.init(torch.Generator().manual_seed(47))
    batch = dict(x_human=np.asarray(_batch(48)[0]), x_objects=np.asarray(_batch(48)[1]),
                 objects_mask=np.ones((B, NO), np.float32))
    gen = torch.Generator().manual_seed(49)
    noise = {"human": gumbel_noise((B, T, NH, 2), gen), "object": gumbel_noise((B, T, NO, 2), gen)}
    want, _ = model.apply(params, noise=noise, **batch)

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read back to the host")

    for name in ("tolist", "item", "__bool__", "__int__", "__float__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got, _ = model.apply(params, generator=torch.Generator().manual_seed(49), **batch)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
