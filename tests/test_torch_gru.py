"""K1 and K2 of the port: the plain versions of tggcn_torch's gru_sequence
and its backward, and the multi-stream BiGRU, against the JAX Pallas kernels
(forward, and backward through their custom VJP) run in interpret mode.

Same inputs (numpy, from a seed) into both. Tolerance rtol 1e-5, atol 1e-6,
as tests/test_gru_pallas.py holds the Pallas kernel to the XLA scan; the
gradients rtol 1e-4, atol 1e-5 (dL/dh is summed over the whole sequence;
tests/test_gru_pallas.py holds the Pallas backward to rtol 2e-4). The float64
gradcheck uses torch's default tolerances.

K1 keeps its gates [r | z | hn] when a gradient will be taken, and K2 reads
them instead of recomputing gh: the kept-gate backward is held to the
recompute route it replaced (``_bwd_recompute``, kept here) and to jax.vjp,
and the kept gates to the ones recomputed from the states. The cuDNN GRU
that chip_smoke.py times beside K1 and K2 (``tggcn_torch.profile_gru``) is
held to the plain versions on the CPU at the same tolerances.

In bfloat16 (the IO dtype ``bench.py`` trains in), the plain versions of
K1 and K2 against the Pallas kernel in bfloat16 in interpret mode, forward
and jax.vjp: every output within two bfloat16 ulps of its largest value
(the TPU kernel recomputes K2's gates from the bfloat16 states, the port
reads K1's, taken from the float32 state), the states also within 5e-4 of
their norm (a state carried in bfloat16 misses it); the wrappers refuse a
mix of dtypes.
"""

import jax
import numpy as np
import pytest
import torch

import tggcn_torch.ops.gru_sequence as gru_ops
from tggcn.nn.gru import init_bigru
from tggcn.ops.gru_pallas import gru_sequence as jax_gru_sequence
from tggcn.ops.gru_pallas import run_multi_bigru_pallas
from tggcn_torch import profile_gru
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.nn.gru import run_multi_bigru
from tggcn_torch.ops.gru_sequence import (KEPT, gru_sequence, gru_sequence_autograd,
                                          gru_sequence_bwd, gru_sequence_bwd_plain,
                                          gru_sequence_plain, previous_states)

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


DIRECTIONS = dict(argvalues=[0, 4, 2], ids=["forward", "reverse", "mixed"])


def _torch_inputs(num_reverse, carried=True, seed=8):
    """(gi, w_hh, b_hh, h0, g) over 4 streams, the last num_reverse reversed."""
    gi, w_hh, b_hh, h0 = _inputs(s=4, seed=seed)
    if not carried:
        h0 = np.zeros_like(h0)
    g = np.random.default_rng(seed + 1).normal(size=gi.shape[:-1] + (w_hh.shape[1],))
    return [torch.tensor(np.asarray(x, np.float32)) for x in (gi, w_hh, b_hh, h0, g)]


def _bwd_recompute(gi, hprev, g, w_hh, b_hh, num_reverse):
    """K2's plain version before K1 kept its gates: (dgi, dgh, dh0), with gh
    recomputed from h_prev at every step."""
    t, s = gi.shape[0], gi.shape[1]
    nf = s - num_reverse
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    dh = hprev.new_zeros(hprev.shape[1:])
    for i in range(t):
        tf, tr = t - 1 - i, i
        at = lambda x: torch.cat([x[tf, :nf], x[tr, nf:]])
        gi_i, hp = at(gi), at(hprev)
        dh = dh + at(g)
        gh = torch.matmul(hp, w_hh) + b_hh[:, None]
        i_r, i_z, i_n = gi_i.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        dtanh = dh * (1.0 - z) * (1.0 - n * n)
        d_ir = dtanh * h_n * r * (1.0 - r)
        d_iz = dh * (hp - n) * z * (1.0 - z)
        dgi_i = torch.cat([d_ir, d_iz, dtanh], dim=-1)
        dgh_i = torch.cat([d_ir, d_iz, dtanh * r], dim=-1)
        dh = dh * z + torch.matmul(dgh_i, w_hh.transpose(1, 2))
        dgi[tf, :nf], dgi[tr, nf:] = dgi_i[:nf], dgi_i[nf:]
        dgh[tf, :nf], dgh[tr, nf:] = dgh_i[:nf], dgh_i[nf:]
    return dgi, dgh, dh


@pytest.mark.parametrize("carried", [False, True], ids=["zero_h0", "carried_h0"])
@pytest.mark.parametrize("num_reverse", **DIRECTIONS)
def test_kept_backward_matches_recompute_route(num_reverse, carried):
    """K2's plain version on the gates the plain forward kept gives the
    recompute route's dgi, dgh and dh0 (the wrapper on CPU tensors too)."""
    gi, w_hh, b_hh, h0, g = _torch_inputs(num_reverse, carried)
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True)
    hprev = previous_states(out, h0, num_reverse)
    want = _bwd_recompute(gi, hprev, g, w_hh, b_hh, num_reverse)
    for run in (gru_sequence_bwd_plain, gru_sequence_bwd):
        got = run(gi, hprev, g, gates, w_hh, num_reverse)
        for name, a, b in zip(("dgi", "dgh", "dh0"), got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{run.__name__} {name}")


@pytest.mark.parametrize("num_reverse", **DIRECTIONS)
def test_kept_gate_backward_matches_pallas(num_reverse):
    """dgi, dh0 and the weight gradients reduced outside the kernel (h_prev x
    dgh) from K2's plain version on the kept gates, with a carried h0,
    against jax.vjp of the Pallas custom VJP."""
    gi, w_hh, b_hh, h0, g = _torch_inputs(num_reverse, seed=10)
    nf = 4 - num_reverse
    a_gi, a_w, a_b, a_h0, a_g = (x.numpy() for x in (gi, w_hh, b_hh, h0, g))
    parts = []
    for lo, hi, reverse in ((0, nf, False), (nf, 4, True)):
        if hi > lo:
            parts.append(_jax_grads(a_gi[:, lo:hi], a_w[lo:hi], a_b[lo:hi], a_h0[lo:hi],
                                    a_g[:, lo:hi], reverse))
    want = [np.concatenate([p[i] for p in parts], axis=1 if i == 0 else 0) for i in range(4)]
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True)
    hprev = previous_states(out, h0, num_reverse)
    dgi, dgh, dh0 = gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse)
    got = [dgi, torch.einsum("tsrh,tsrg->shg", hprev, dgh), dgh.sum(dim=(0, 2)), dh0]
    for name, a, w in zip(("dgi", "dW_hh", "db_hh", "dh0"), got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("num_reverse", **DIRECTIONS)
def test_kept_gates_equal_recomputed(num_reverse):
    """The gates K1 keeps, in KEPT's order, are r, z and hn = h_prev @ w_hh_n
    + b_hh_n recomputed from the state each step read; keeping changes no
    state."""
    gi, w_hh, b_hh, h0, _ = _torch_inputs(num_reverse, seed=12)
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True)
    assert KEPT == ("r", "z", "hn") and gates.shape == gi.shape
    torch.testing.assert_close(out, gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse),
                               rtol=0, atol=0)
    hprev = previous_states(out, h0, num_reverse)
    gh = torch.einsum("tsrh,shg->tsrg", hprev, w_hh) + b_hh[None, :, None]
    h = w_hh.shape[1]
    want = dict(r=torch.sigmoid(gi[..., :h] + gh[..., :h]),
                z=torch.sigmoid(gi[..., h:2 * h] + gh[..., h:2 * h]), hn=gh[..., 2 * h:])
    for i, name in enumerate(KEPT):
        torch.testing.assert_close(gates[..., i * h:(i + 1) * h], want[name], rtol=RTOL,
                                   atol=ATOL, msg=name)
    n = torch.tanh(gi[..., 2 * h:] + want["r"] * want["hn"])
    torch.testing.assert_close(out, (1 - want["z"]) * n + want["z"] * hprev, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad", "gradient"])
def test_function_keeps_gates_only_for_a_gradient(monkeypatch, mode):
    """The forward keeps the gates only when a gradient will be taken (grad
    enabled and an input requiring one); a served call keeps none."""
    keeps = []
    plain = gru_ops.gru_sequence_plain

    def spy(*args, keep=False, **kwargs):
        keeps.append(keep)
        return plain(*args, keep=keep, **kwargs)

    monkeypatch.setattr(gru_ops, "gru_sequence_plain", spy)
    gi, w_hh, b_hh, h0, g = _torch_inputs(2, seed=14)
    w_hh.requires_grad_(mode == "gradient")
    if mode == "no_grad":
        with torch.no_grad():
            out = gru_sequence_autograd(gi, w_hh, b_hh, h0, 2, use_kernels=False)
    else:
        out = gru_sequence_autograd(gi, w_hh, b_hh, h0, 2, use_kernels=False)
    assert keeps == [mode == "gradient"]
    torch.testing.assert_close(out.detach(), plain(gi, w_hh.detach(), b_hh, h0, 2),
                               rtol=0, atol=0)
    if mode == "gradient":
        out.backward(g)
        assert w_hh.grad is not None and torch.isfinite(w_hh.grad).all()


@pytest.mark.parametrize("num_reverse", **DIRECTIONS)
def test_cudnn_yardstick_matches_plain(num_reverse):
    """The library yardstick of chip_smoke.py's k1 and k2 phases: one
    torch.nn.GRU per stream with identity input weights, fed gi, computes
    K1's states, and its gradients with respect to its inputs and initial
    states are K2's dgi and dh0 (here on the CPU, cuDNN's own on the card)."""
    gi, w_hh, b_hh, h0, g = _torch_inputs(num_reverse, seed=16)
    out, gates = gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True)
    grus = profile_gru.cudnn_grus(w_hh, b_hh)
    xs, h0s = profile_gru.cudnn_inputs(gi, h0, num_reverse)
    for x in xs + h0s:
        x.requires_grad_(True)
    ys = profile_gru.cudnn_sequence(grus, xs, h0s)
    np.testing.assert_allclose(profile_gru.cudnn_states(ys, num_reverse).detach().numpy(),
                               out.numpy(), rtol=RTOL, atol=ATOL)
    nf = 4 - num_reverse
    gys = [g[:, i] if i < nf else g[:, i].flip(0) for i in range(4)]
    grads = torch.autograd.grad(ys, xs + h0s, gys)
    dgi, _, dh0 = gru_sequence_bwd_plain(gi, previous_states(out, h0, num_reverse), g, gates,
                                         w_hh, num_reverse)
    got_dgi = torch.stack([d if i < nf else d.flip(0) for i, d in enumerate(grads[:4])], dim=1)
    np.testing.assert_allclose(got_dgi.numpy(), dgi.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(torch.cat(grads[4:]).numpy(), dh0.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_profile_inputs_drive_k1_and_k2():
    """profile_gru's seeded inputs, which chip_smoke.py's k1 and k2 phases
    use, are K1's and K2's arguments: K2's are the states each step read and
    the gates the plain forward kept, with an upstream gradient of the
    states' shape."""
    gen = torch.Generator().manual_seed(0)
    fwd = profile_gru.gru_inputs("cpu", gen, 5, 4, 3, 8)
    gi, w_hh, b_hh, h0 = fwd
    assert [tuple(x.shape) for x in fwd] == [(5, 4, 3, 24), (4, 8, 24), (4, 24), (4, 3, 8)]
    assert float(w_hh.abs().max()) <= 8 ** -0.5 and float(gi.abs().max()) <= 1.0
    args = profile_gru.gru_bwd_inputs(*fwd, 2, gen)
    out, gates = gru_sequence_plain(*fwd, 2, keep=True)
    torch.testing.assert_close(args[1], previous_states(out, h0, 2), rtol=0, atol=0)
    torch.testing.assert_close(args[3], gates, rtol=0, atol=0)
    assert args[2].shape == out.shape and args[0] is gi and args[4] is w_hh
    dgi, dgh, dh0 = gru_sequence_bwd(*args, 2)
    assert dgi.shape == dgh.shape == gi.shape and dh0.shape == h0.shape


@pytest.mark.parametrize("bad", ["gates_shape", "strided", "float64"])
def test_bwd_wrapper_checks_its_inputs(bad):
    """K2's wrapper refuses, before any launch, gates of the wrong shape, a
    non-contiguous input and another dtype than float32 (checked here on
    CPU tensors through the check the CUDA route runs)."""
    gi, w_hh, b_hh, h0, g = _torch_inputs(2, seed=18)
    t, s, r, g3 = gi.shape
    h = g3 // 3
    gates = torch.zeros_like(gi)
    if bad == "gates_shape":
        gates = gates[..., :2 * h]
    elif bad == "strided":
        gates = torch.zeros(t, s, r, 2 * g3)[..., ::2]
    else:
        gates = gates.double()
    with pytest.raises(ValueError, match="gates"):
        gru_ops._check("gru_sequence_bwd", gi.device,
                       {"gi": (gi, (t, s, r, g3)), "gates": (gates, (t, s, r, g3))}, h, 2)


def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def assert_within_bf16_ulps(got, want, ulps, what):
    """|got - want| within `ulps` bfloat16 ulps of want's largest value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, limit = np.abs(got - want).max(), ulps * bf16_ulp(np.abs(want).max())
    assert err <= limit, f"{what}: {err:.3e} (limit {limit:.3e})"


def _bf16(*arrays):
    """numpy arrays rounded to bfloat16: (the JAX arrays, the torch tensors)."""
    jx = [jax.numpy.asarray(a, jax.numpy.bfloat16) for a in arrays]
    return jx, [torch.tensor(np.asarray(a.astype(jax.numpy.float32))).bfloat16() for a in jx]


@pytest.mark.parametrize("carried", [False, True], ids=["zero_h0", "carried_h0"])
@pytest.mark.parametrize("num_reverse", **DIRECTIONS)
def test_bf16_plain_versions_match_pallas(num_reverse, carried):
    """K1's and K2's plain versions in bfloat16 through the autograd
    Function against the Pallas kernel in bfloat16 and jax.vjp of its custom
    VJP: states, dgi, dW_hh, db_hh and dh0 within two bfloat16 ulps."""
    gi, w_hh, b_hh, h0, g = _torch_inputs(num_reverse, carried, seed=30)
    (jgi, jw, jb, jh0, jg), leaves = _bf16(*(x.numpy() for x in (gi, w_hh, b_hh, h0, g)))
    nf = 4 - num_reverse
    outs, grads = [], []
    for lo, hi, reverse in ((0, nf, False), (nf, 4, True)):
        if hi > lo:
            f = lambda *a: jax_gru_sequence(*a, reverse, True)
            out, vjp = jax.vjp(f, jgi[:, lo:hi], jw[lo:hi], jb[lo:hi], jh0[lo:hi])
            outs.append(out)
            grads.append(vjp(jg[:, lo:hi]))
    want = np.concatenate([np.asarray(o.astype(jax.numpy.float32)) for o in outs], axis=1)
    want_grads = [np.concatenate([np.asarray(p[i].astype(jax.numpy.float32)) for p in grads],
                                 axis=1 if i == 0 else 0) for i in range(4)]
    leaves = leaves[:4]
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = gru_sequence_autograd(*leaves, num_reverse=num_reverse)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulps(got.detach().float(), want, 2, "states")
    # Both carry a float32 state (measured: equal states); a state rounded
    # to bfloat16 every step, as JAX's XLA route carries it, lies 1.9e-3
    # away in norm.
    err = np.linalg.norm(got.detach().float().numpy() - want) / np.linalg.norm(want)
    assert err < 5e-4, f"states: {err:.3e} of their norm"
    got.backward(torch.tensor(np.asarray(jg.astype(jax.numpy.float32))).bfloat16())
    for name, leaf, w in zip(("dgi", "dW_hh", "db_hh", "dh0"), leaves, want_grads):
        assert leaf.grad.dtype == torch.bfloat16, name
        assert_within_bf16_ulps(leaf.grad.float(), w, 2, name)


def test_bf16_multi_bigru_matches_pallas(bigru_setup):
    """The three-stream BiGRU in bfloat16 (float32 weights cast to the
    inputs' dtype, as run_multi_bigru_pallas casts them) against the Pallas
    kernel in bfloat16."""
    params, xs = bigru_setup
    jxs, txs = _bf16(*xs)
    want = run_multi_bigru_pallas(params, jxs, interpret=True)
    got = run_multi_bigru(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)), txs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        assert_within_bf16_ulps(g.float(), np.asarray(w.astype(jax.numpy.float32)), 2,
                                f"stream {i}")


@pytest.mark.parametrize("bad", ["gi_float32", "h0_float32", "gates_bfloat16", "float16"])
def test_wrappers_refuse_mixed_dtypes(bad):
    """K1's and K2's wrappers take float32 or bfloat16 IO, all of one dtype
    (K2's kept gates float32), and refuse any other mix (checked on CPU
    tensors through the check the CUDA route runs)."""
    gi, w_hh, b_hh, h0, g = (x.bfloat16() for x in _torch_inputs(2, seed=31))
    t, s, r, g3 = gi.shape
    h = g3 // 3
    gates = torch.zeros(gi.shape)
    if bad == "gi_float32":
        gi = gi.float()
    elif bad == "h0_float32":
        h0 = h0.float()
    elif bad == "gates_bfloat16":
        gates = gates.bfloat16()
    else:
        gi, w_hh, b_hh, h0 = (x.half() for x in (gi, w_hh, b_hh, h0))
    with pytest.raises(ValueError):
        gru_ops._check("gru_sequence", gi.device,
                       {"gi": (gi, (t, s, r, g3)), "w_hh": (w_hh, (s, h, g3)),
                        "b_hh": (b_hh, (s, g3)), "h0": (h0, (s, r, h))}, h, 2)
        gru_ops._check("gru_sequence_bwd", gi.device,
                       {"gi": (gi, (t, s, r, g3)), "gates": (gates, (t, s, r, g3))}, h, 2,
                       float32=("gates",))


def test_round_carry_carries_the_rounded_states():
    """round_carry (the control chip_smoke.py holds the bfloat16 checks to)
    makes K1's plain version carry the bfloat16 states it returns, as JAX's
    XLA route does: each step equals one step from the state returned
    before it, and the sequence differs from the float32-state one."""
    gi, w_hh, b_hh, h0, _ = (x.bfloat16() for x in _torch_inputs(0, seed=32))
    out = gru_ops.gru_sequence_plain(gi, w_hh, b_hh, h0, round_carry=True)
    prev = h0
    for i in range(gi.shape[0]):
        step = gru_ops.gru_sequence_plain(gi[i:i + 1], w_hh, b_hh, prev)
        torch.testing.assert_close(out[i], step[0], rtol=0, atol=0)
        prev = out[i]
    assert not torch.equal(out, gru_ops.gru_sequence_plain(gi, w_hh, b_hh, h0))


@pytest.mark.parametrize("num_reverse", **DIRECTIONS)
def test_round_carry_changes_nothing_in_float32(num_reverse):
    """In float32 IO there is nothing to round the carry to: K1's and K2's
    plain versions give the same bits with round_carry."""
    gi, w_hh, b_hh, h0, g = _torch_inputs(num_reverse, seed=33)
    out, gates = gru_ops.gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True)
    again = gru_ops.gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True,
                                       round_carry=True)
    assert torch.equal(out, again[0]) and torch.equal(gates, again[1])
    hprev = gru_ops.previous_states(out, h0, num_reverse)
    want = gru_ops.gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse)
    got = gru_ops.gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse,
                                         round_carry=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
