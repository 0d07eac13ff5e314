"""K1 and K2 of the port: the plain versions of tggcn_torch's gru_sequence
and its backward, and the multi-stream BiGRU, against the JAX Pallas kernels
(forward, and backward through their custom VJP) run in interpret mode.

Same inputs (numpy, from a seed) into both. Tolerance rtol 1e-5, atol 1e-6,
as tests/test_gru_pallas.py holds the Pallas kernel to the XLA scan; the
gradients rtol 1e-4, atol 1e-5 (dL/dh is summed over the whole sequence;
tests/test_gru_pallas.py holds the Pallas backward to rtol 2e-4). The float64
gradcheck uses torch's default tolerances.
"""

import jax
import numpy as np
import pytest
import torch

from tggcn.nn.gru import init_bigru
from tggcn.ops.gru_pallas import gru_sequence as jax_gru_sequence
from tggcn.ops.gru_pallas import run_multi_bigru_pallas
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.nn.gru import run_multi_bigru
from tggcn_torch.ops.gru_sequence import (gru_sequence, gru_sequence_autograd,
                                          gru_sequence_plain)

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _inputs(t=7, s=3, r=5, h=8, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    return (rng.normal(size=(t, s, r, 3 * h)).astype(np.float32),
            rng.uniform(-bound, bound, size=(s, h, 3 * h)).astype(np.float32),
            rng.uniform(-bound, bound, size=(s, 3 * h)).astype(np.float32),
            rng.normal(size=(s, r, h)).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_sequence_matches_pallas(reverse):
    gi, w_hh, b_hh, h0 = _inputs()
    want = jax_gru_sequence(gi, w_hh, b_hh, h0, reverse, True)
    got = gru_sequence(*map(torch.tensor, (gi, w_hh, b_hh, h0)),
                       num_reverse=gi.shape[1] if reverse else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mixed_directions_match_pallas():
    """The trailing num_reverse streams run backward, the others forward."""
    gi, w_hh, b_hh, h0 = _inputs(s=4, seed=1)
    fwd = jax_gru_sequence(gi[:, :2], w_hh[:2], b_hh[:2], h0[:2], False, True)
    bwd = jax_gru_sequence(gi[:, 2:], w_hh[2:], b_hh[2:], h0[2:], True, True)
    got = gru_sequence_plain(*map(torch.tensor, (gi, w_hh, b_hh, h0)), num_reverse=2)
    np.testing.assert_allclose(got.numpy(), np.concatenate([fwd, bwd], axis=1),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def bigru_setup():
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    hidden = 8
    params = [init_bigru(k, hidden, hidden) for k in keys]
    rng = np.random.default_rng(2)
    b, t = 2, 7
    xs = [rng.normal(size=(b, t, e, hidden)).astype(np.float32) for e in (2, 3, 1)]
    return params, xs


@pytest.mark.parametrize("carried", [False, True], ids=["zero_h0", "carried_h0"])
def test_multi_bigru_matches_pallas(bigru_setup, carried):
    """Three streams of 4, 6 and 2 rows: padding to the widest stream."""
    params, xs = bigru_setup
    h0s = None
    if carried:
        rng = np.random.default_rng(3)
        h0s = [rng.normal(size=(x.shape[0], x.shape[2], 8)).astype(np.float32) for x in xs]
    want = run_multi_bigru_pallas(params, xs, h0_fwd_list=h0s, interpret=True)
    got = run_multi_bigru(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
                          [torch.tensor(x) for x in xs],
                          None if h0s is None else [torch.tensor(h) for h in h0s])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"stream {i}")


def _jax_grads(gi, w_hh, b_hh, h0, g, reverse):
    f = lambda *a: jax_gru_sequence(*a, reverse, True)
    _, vjp = jax.vjp(f, gi, w_hh, b_hh, h0)
    return [np.asarray(x) for x in vjp(g)]


@pytest.mark.parametrize("num_reverse", [0, 4, 2], ids=["forward", "reverse", "mixed"])
def test_gru_sequence_backward_matches_pallas(num_reverse):
    """dgi, dW_hh, db_hh and dh0 through the autograd Function (K2's plain
    version) against jax.vjp of the Pallas custom VJP; the trailing
    num_reverse streams run backward in time."""
    gi, w_hh, b_hh, h0 = _inputs(s=4, seed=4)
    g = np.random.default_rng(5).normal(size=gi.shape[:-1] + (w_hh.shape[1],)).astype(np.float32)
    nf = 4 - num_reverse
    parts = []
    for lo, hi, reverse in ((0, nf, False), (nf, 4, True)):
        if hi > lo:
            parts.append(_jax_grads(gi[:, lo:hi], w_hh[lo:hi], b_hh[lo:hi], h0[lo:hi],
                                    g[:, lo:hi], reverse))
    want = [np.concatenate([p[i] for p in parts], axis=1 if i == 0 else 0) for i in range(4)]
    leaves = [torch.tensor(x, requires_grad=True) for x in (gi, w_hh, b_hh, h0)]
    gru_sequence_autograd(*leaves, num_reverse=num_reverse).backward(torch.tensor(g))
    for name, leaf, w in zip(("dgi", "dW_hh", "db_hh", "dh0"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_gru_sequence_backward_gradcheck():
    """The plain backward against finite differences of the plain forward, float64."""
    gi, w_hh, b_hh, h0 = _inputs(t=4, s=3, r=2, h=4, seed=6)
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (gi, w_hh, b_hh, h0)]
    assert torch.autograd.gradcheck(
        lambda *a: gru_sequence_autograd(*a, num_reverse=1), leaves)


def test_multi_bigru_gradients_match_pallas(bigru_setup):
    """Gradients of every weight and input of the three-stream BiGRU
    against jax.grad of run_multi_bigru_pallas: the rows that pad the
    narrower streams get no gradient into the inputs."""
    params, xs = bigru_setup
    rng = np.random.default_rng(7)
    ws = [rng.normal(size=x.shape[:3] + (16,)).astype(np.float32) for x in xs]

    def jax_loss(p, xs_):
        outs = run_multi_bigru_pallas(p, xs_, interpret=True)
        return sum(jax.numpy.sum(o * w) for o, w in zip(outs, ws))

    want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, xs)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    leaves = [x for p in tparams for d in p.values() for x in d.values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    outs = run_multi_bigru(tparams, txs)
    sum((o * torch.tensor(w)).sum() for o, w in zip(outs, ws)).backward()
    for i, (tp, wp) in enumerate(zip(tparams, want_p)):
        for d in ("fwd", "bwd"):
            for k, leaf in tp[d].items():
                np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wp[d][k]),
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"stream {i} {d} {k}")
    for i, (tx, wx) in enumerate(zip(txs, want_x)):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"input {i}")
