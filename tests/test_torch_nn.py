"""The port's plain layers against their tggcn counterparts on the CPU,
forward and, for the decision estimators and the fused GeoGCN, backward.

Same inputs and weights (numpy, from a seed; JAX weights carried over with
params_from_numpy) into both. Tolerance rtol 1e-5, atol 1e-6: both sides
compute in float32 with the same operation order up to matmul blocking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tggcn.nn import messages as jax_messages
from tggcn.nn.batchnorm import apply_batchnorm as jax_batchnorm
from tggcn.nn.geo_gcn import apply_geo_gcn as jax_geo_gcn
from tggcn.nn.geo_gcn import init_geo_gcn as jax_init_geo_gcn
from tggcn.nn.mlp import apply_bilinear as jax_apply_bilinear
from tggcn.nn.mlp import apply_mlp as jax_apply_mlp
from tggcn.nn.mlp import init_bilinear as jax_init_bilinear
from tggcn.nn.mlp import init_mlp as jax_init_mlp
from tggcn.nn.temporal import reorder_hidden_states as jax_reorder
from tggcn.ops.geo_gcn_pallas import geo_gcn_fused as jax_geo_gcn_fused
from tggcn.ops.geo_gcn_pallas import geo_gcn_reference
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.nn.batchnorm import apply_batchnorm
from tggcn_torch.nn.distributions import discrete_estimator
from tggcn_torch.nn.geo_gcn import apply_geo_gcn, init_geo_gcn
from tggcn_torch.nn.init import fan_in_uniform
from tggcn_torch.nn.messages import compute_message_features, masked_softmax
from tggcn_torch.nn.mlp import apply_bilinear, apply_mlp, init_bilinear
from tggcn_torch.nn.temporal import reorder_hidden_states
from tggcn_torch.ops.geo_gcn import geo_gcn_fused_autograd, geo_gcn_plain

RTOL, ATOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("activations", [
    ["relu", "relu"], ["tanh", "sigmoid"],
    ["relu", {"name": "logsoftmax", "dim": -1}]], ids=["relu", "tanh_sigmoid", "logsoftmax"])
def test_mlp(activations):
    params = jax_init_mlp(jax.random.PRNGKey(0), [12, 10, 5])
    x = np.random.default_rng(0).normal(size=(3, 4, 12)).astype(np.float32)
    close(apply_mlp(params_from_numpy(_np(params)), torch.tensor(x), activations),
          jax_apply_mlp(params, x, activations=activations))


def test_batchnorm_eval_uses_running_statistics():
    rng = np.random.default_rng(1)
    bn = {"params": {"scale": rng.normal(size=(5, 4)), "bias": rng.normal(size=(5, 4))},
          "state": {"mean": rng.normal(size=(5, 4)), "var": rng.uniform(0.5, 2, size=(5, 4))}}
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    want, _ = jax_batchnorm(jax.tree_util.tree_map(jnp.float32, bn), x, (0, 1), train=False)
    got, state = apply_batchnorm(params_from_numpy(bn), torch.tensor(x), (0, 1))
    close(got, want)
    np.testing.assert_array_equal(state["mean"].numpy(), np.float32(bn["state"]["mean"]))


def test_geo_gcn():
    params = jax_init_geo_gcn(jax.random.PRNGKey(2), 26)
    rng = np.random.default_rng(2)
    params["bn"]["state"]["mean"] = jnp.asarray(rng.normal(size=(26, 4)), jnp.float32)
    x = rng.normal(size=(2, 3, 26, 4)).astype(np.float32)
    want, _ = jax_geo_gcn(params, x, train=False)
    got, _ = apply_geo_gcn(params_from_numpy(_np(params)), torch.tensor(x))
    close(got, want)


def test_init_shapes_and_bounds():
    g = torch.Generator().manual_seed(0)
    params = init_geo_gcn(g, 26)
    jax_params = jax_init_geo_gcn(jax.random.PRNGKey(0), 26)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax_params)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == shapes
    w = fan_in_uniform(g, (1000,), 25)
    assert float(w.abs().max()) <= 0.2 and float(w.abs().max()) > 0.19


def test_masked_softmax_fully_masked_row_is_zero():
    scores = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    got = masked_softmax(scores, mask)
    close(got, jax_messages.masked_softmax(scores.numpy(), mask.numpy()))
    assert torch.equal(got[1], torch.zeros(3))


@pytest.mark.parametrize("style", ["v2", "v3"])
@pytest.mark.parametrize("edge", ["self_excluded", "masked_senders"])
def test_messages(style, edge):
    """Generic messages with (scaled) dot attention; one receiver row has
    no unmasked sender, and must get a zero message and zero weights."""
    rng = np.random.default_rng(3)
    params = {"msg": jax_init_mlp(jax.random.PRNGKey(3), [6, 5])}
    b, t, n = 2, 3, 4
    recv = rng.normal(size=(b, t, n, 6)).astype(np.float32)
    if edge == "self_excluded":
        send, mask, exclude = recv, None, True
        recv_t = send_t = torch.tensor(recv)
        mask_t = None
    else:
        send = rng.normal(size=(b, t, 3, 6)).astype(np.float32)
        mask = np.array([[1, 0, 1], [0, 0, 0]], np.float32)[:, None, None, :]
        exclude = False
        recv_t, send_t, mask_t = torch.tensor(recv), torch.tensor(send), torch.tensor(mask)
    kw = dict(message_type="v2", message_granularity="v1", message_aggregation="att",
              attention_style=style)
    want_msg, want_att = jax_messages.compute_message_features(
        params, recv, send, mask, exclude_self=exclude, **kw)
    got_msg, got_att = compute_message_features(
        params_from_numpy(_np(params)), recv_t, send_t, mask_t, exclude_self=exclude, **kw)
    close(got_msg, want_msg)
    close(got_att, want_att)
    if edge == "masked_senders":
        assert torch.equal(got_msg[1], torch.zeros_like(got_msg[1]))
    assert torch.isfinite(got_att).all()


def test_messages_outside_slice_raise():
    """Every message kind of the reference is in the port (relational and
    'specific' ones are held to JAX in tests/test_torch_general_jax.py); a
    message type or granularity that is none of them raises."""
    x = torch.zeros(1, 2, 4)
    params = {"msg": {"layers": [{"w": torch.zeros(4, 3)}]}}
    for kind in (dict(message_type="v3", message_granularity="v1"),
                 dict(message_type="v2", message_granularity="v3")):
        with pytest.raises(ValueError, match="unknown message"):
            compute_message_features(params, x, x, None, message_aggregation="mp",
                                     attention_style="v3", **kind)


def test_reorder_hidden_states():
    rng = np.random.default_rng(4)
    h = rng.normal(size=(3, 9, 5)).astype(np.float32)
    u = (rng.uniform(size=(3, 9)) > 0.6).astype(np.float32)
    u[1] = 0.0            # no end frame: every frame keeps its own state
    close(reorder_hidden_states(torch.tensor(h), torch.tensor(u)), jax_reorder(h, u))


def test_reorder_hidden_states_gradient():
    """The reorder's fixed-order backward against autograd of torch.gather:
    each state's gradient is the sum over the frames that read it."""
    rng = np.random.default_rng(11)
    h = torch.tensor(rng.normal(size=(4, 9, 5)).astype(np.float32), requires_grad=True)
    u = (rng.uniform(size=(4, 9)) > 0.6).astype(np.float32)
    u[1] = 0.0            # no end frame
    u[2, -1] = 1.0        # every frame in a segment
    u[3] = 1.0            # every frame its own segment
    g = torch.tensor(rng.normal(size=(4, 9, 5)).astype(np.float32))
    (got,) = torch.autograd.grad(reorder_hidden_states(h, torch.tensor(u)), h, g)
    want = torch.zeros_like(h)
    for b in range(4):
        for t in range(9):
            ends = [k for k in range(t, 9) if u[b, k]]
            want[b, ends[0] if ends else t] += g[b, t]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_straight_through_decisions():
    """Hard thresholds forward; the straight-through gradient is the identity."""
    x = torch.tensor([0.2, 0.5, 0.50001, 0.9], requires_grad=True)
    hard, soft = discrete_estimator(x, "st", threshold=0.5)
    assert hard.tolist() == [0.0, 0.0, 1.0, 1.0] and soft is x
    (hard * torch.tensor([1.0, 2.0, 3.0, 4.0])).sum().backward()
    assert x.grad.tolist() == [1.0, 2.0, 3.0, 4.0]
    with pytest.raises(ValueError, match="noise or a generator"):
        discrete_estimator(x, "gs")


def test_gumbel_sigmoid_matches_jax():
    """'gs' with the noise JAX drew: hard, soft and the gradient of a
    weighted sum of both agree with jax.grad."""
    from tggcn.nn.distributions import discrete_estimator as jax_estimator

    rng = np.random.default_rng(5)
    p = rng.uniform(0.05, 0.95, size=(2, 6, 3, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.gumbel(key, (2, 6, 3, 2), dtype=jnp.float32))
    w_hard, w_soft = (rng.normal(size=p.shape).astype(np.float32) for _ in range(2))

    def jax_obj(x):
        hard, soft = jax_estimator(x, "gs", threshold=0.5, key=key)
        return jnp.sum(hard * w_hard + soft * w_soft), (hard, soft)

    (_, (want_hard, want_soft)), want_grad = jax.value_and_grad(jax_obj, has_aux=True)(p)
    x = torch.tensor(p, requires_grad=True)
    hard, soft = discrete_estimator(x, "gs", threshold=0.5, noise=torch.tensor(noise))
    (hard * torch.tensor(w_hard) + soft * torch.tensor(w_soft)).sum().backward()
    np.testing.assert_array_equal(hard.detach().numpy(), np.asarray(want_hard))
    close(soft.detach(), want_soft)
    close(x.grad, want_grad)
    # Drawn from a generator instead: hard decisions are 0/1 and the draw is seeded.
    gen = lambda: torch.Generator().manual_seed(3)
    h1, s1 = discrete_estimator(x.detach(), "gs", generator=gen())
    h2, s2 = discrete_estimator(x.detach(), "gs", generator=gen())
    assert torch.equal(h1, h2) and torch.equal(s1, s2)
    assert set(h1.unique().tolist()) <= {0.0, 1.0}


def test_batchnorm_training_matches_jax():
    """Training statistics: batch-normalised output (biased variance) and the
    running state moved toward the batch mean and unbiased variance."""
    rng = np.random.default_rng(6)
    bn = {"params": {"scale": rng.normal(size=(5, 4)), "bias": rng.normal(size=(5, 4))},
          "state": {"mean": rng.normal(size=(5, 4)), "var": rng.uniform(0.5, 2, size=(5, 4))}}
    x = (rng.normal(size=(2, 3, 5, 4)) * 3 + 1).astype(np.float32)
    want, want_state = jax_batchnorm(jax.tree_util.tree_map(jnp.float32, bn), x, (0, 1),
                                     train=True)
    got, state = apply_batchnorm(params_from_numpy(bn), torch.tensor(x), (0, 1), train=True)
    close(got, want)
    for k in ("mean", "var"):
        close(state[k], want_state[k])


def test_bilinear():
    params = jax_init_bilinear(jax.random.PRNGKey(8), 6, 5, 3)
    rng = np.random.default_rng(8)
    x1 = rng.normal(size=(2, 4, 6)).astype(np.float32)
    x2 = rng.normal(size=(2, 4, 5)).astype(np.float32)
    close(apply_bilinear(params_from_numpy(_np(params)), torch.tensor(x1), torch.tensor(x2)),
          jax_apply_bilinear(params, x1, x2))
    torch_params = init_bilinear(torch.Generator().manual_seed(0), 6, 5, 3)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), torch_params) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), params)


@pytest.mark.parametrize("kind", ["v1", "v4", "mp", "distances"])
@pytest.mark.parametrize("edge", ["self_excluded", "masked_senders"])
def test_messages_modes(kind, edge):
    """Generic messages with concat (v1) or bilinear (v4) attention, mean
    pooling, or inverse-distance attention with exact zero distances; one
    receiver row has no unmasked sender (and, with distances, one has every
    distance zero), and must get a zero message and zero weights."""
    rng = np.random.default_rng(9)
    f, b, t, n = 6, 2, 3, 4
    key_m, key_a = jax.random.split(jax.random.PRNGKey(9))
    params = {"msg": jax_init_mlp(key_m, [f, 5])}
    if kind == "v1":
        params["att"] = jax_init_mlp(key_a, [2 * f, 1])
    elif kind == "v4":
        params["att"] = jax_init_bilinear(key_a, f, f, 1)
    recv = rng.normal(size=(b, t, n, f)).astype(np.float32)
    if edge == "self_excluded":
        send, mask, exclude = recv, None, True
    else:
        send = rng.normal(size=(b, t, 3, f)).astype(np.float32)
        mask = np.array([[1, 0, 1], [0, 0, 0]], np.float32)[:, None, None, :]
        exclude = False
    dists = None
    if kind == "distances":
        dists = rng.uniform(0.2, 2.0, size=(b, t, n, send.shape[2])).astype(np.float32)
        dists[rng.uniform(size=dists.shape) < 0.25] = 0.0
        dists[0, 1, 2] = 0.0
    kw = dict(message_type="v2", message_granularity="v1",
              message_aggregation="mp" if kind == "mp" else "att",
              attention_style=kind if kind in ("v1", "v4") else "v3")
    want_msg, want_att = jax_messages.compute_message_features(
        params, recv, send, mask, exclude_self=exclude, distances=dists, **kw)
    tensor = lambda x: None if x is None else torch.tensor(x)
    got_msg, got_att = compute_message_features(
        params_from_numpy(_np(params)), tensor(recv), tensor(send), tensor(mask),
        exclude_self=exclude, distances=tensor(dists), **kw)
    close(got_msg, want_msg)
    if kind == "mp":
        assert got_att is None and want_att is None
    else:
        close(got_att, want_att)
        assert torch.isfinite(got_att).all()
    if edge == "masked_senders":
        assert torch.equal(got_msg[1], torch.zeros_like(got_msg[1]))
    if kind == "distances":
        assert torch.equal(got_att[0, 1, 2], torch.zeros_like(got_att[0, 1, 2]))


@pytest.mark.parametrize("v", [19, 26, 30])
def test_geo_gcn_fused_plain(v):
    """K6's plain version against the Pallas kernel (interpret mode) and
    geo_gcn_reference over N = 21 frames (not a multiple of the TPU tile of
    16), and the gradient of its autograd Function against autograd of the
    plain version."""
    params = jax_init_geo_gcn(jax.random.PRNGKey(v), v)
    weights = [params[name][key] for name in ("embed1", "embed2", "s1", "s2")
               for key in ("w", "b")] + [params["weight"]]
    x = np.random.default_rng(v).normal(size=(21, v, 4)).astype(np.float32)
    ours = [torch.tensor(np.asarray(w)) for w in weights]
    got = geo_gcn_plain(torch.tensor(x), *ours)
    np.testing.assert_allclose(got.numpy(), np.asarray(geo_gcn_reference(x, *weights)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_geo_gcn_fused(x, *weights, 16, True)),
                               rtol=1e-5, atol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (torch.tensor(x), *ours)]
    g = torch.tensor(np.random.default_rng(v + 1).normal(size=got.shape).astype(np.float32))
    grads = torch.autograd.grad(geo_gcn_fused_autograd(*leaves), leaves, g)
    want = torch.autograd.grad(geo_gcn_plain(*leaves), leaves, g)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_geo_gcn_fused_route_matches_jax():
    """apply_geo_gcn with the fused route (use_pallas_geo_gcn) against
    JAX's apply_geo_gcn."""
    params = jax_init_geo_gcn(jax.random.PRNGKey(12), 26)
    x = np.random.default_rng(12).normal(size=(2, 3, 26, 4)).astype(np.float32)
    want, _ = jax_geo_gcn(params, x, train=False)
    got, _ = apply_geo_gcn(params_from_numpy(_np(params)), torch.tensor(x), fused=True)
    close(got, want)
